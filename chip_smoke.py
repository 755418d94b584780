#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--nnz N] [--out report.json] [--tuning] [--split-only]

What it does, in order — any failure raises and the run exits non-zero:

1. ``device``    — needs a CUDA device (exits 1 without one); builds every
   CUDA kernel of ``src/repro_torch/kernels/csrc`` from source with nvcc
   (all sources at once) and reports the build time.
2. ``data``      — a NELL-2-shaped synthetic sparse tensor (FROSTT's NELL-2
   dimensions 12092 x 9184 x 28818, power-law fibers, ``--nnz`` samples,
   seed 0) and its three mode-rooted CSFs: the host-side preprocessing.
   Then a dense f32 tensor 1024 x 768 x 1152 (non-cubic, every mode a
   multiple of 128) drawn on the card from a seeded generator.
3. ``kernels``   — each kernel's wrapper against its plain PyTorch version
   on the card, at the main path's shapes and at small ragged shapes, with
   CUDA-event timings (median after warm-up) beside the least time the card
   could take for the same bytes and operations and, where one PyTorch call
   computes the same function, that call's time. Kernel 1 on each of its
   routes (``chunk``, ``three_pass``) at the three mode layouts, the routes
   bit-equal to each other and the small cases bit-equal to the CPU on both,
   each call's device time split by operation under ``torch.profiler``
   (``passes_ms``). Kernel 2 on its three
   routes: the wgmma route at the MLP projection and at the served
   prefill's four projection shapes (M = 8192), each timed in turns with
   the tile route, and at one 128-deep stage (its fill and epilogue alone);
   the tile route at a ragged 1000-column head (its K split over a cluster,
   every split of 1 to 8 bit-equal and timed); the decode route at
   granite-8b's four decode shapes (8 rows), timed against the tile route in
   turns, plus both at M = 1 and 16 (the ends of the rows ``M_DECODE``
   sends to the decode route; ``--tuning`` sweeps M over 1..64 and times
   every cluster size, the evidence kept in PERF.md). The device phase fails
   unless kernel 2's library holds integer warpgroup MMAs (SASS ``IGMMA``)
   and TMA loads (``UTMALDG``). The ordered fold on the exact-fit MTTKRP
   (``stream_mttkrp`` on mode 2 at full size): its chain route (one launch,
   the contributions formed in the kernel) bit-equal to the parent's stepped
   route (the chain eagerly in 64Ki-nonzero steps, a fold-route launch
   each), both timed and split by kernel; ``stream_mttkrp`` on the skewed
   mode 0 at full size bit-equal to the same on the CPU, and its head row's
   launch alone; the ``exact`` backend's ``mttkrp_sparse`` on every mode,
   the call beside its chain-route launch (``exact_sparse_split``). Kernel 4
   on each mode of the dense tensor: on its int8 codes (the ring's codes
   front end, timed beside the partials kernel on the same codes), and
   reading the f32 tensor in place (``mttkrp_psram_strided``, the dense
   path's route): its row scales and its converter's codes equal to
   ``quantize_symmetric``'s over the whole tensor, its output bit-equal to
   the codes front end and repeatable; the call, its row-max pass and its
   ring timed alone. Kernel 5 on each mode's stream at full size: its rows
   route on the padded chain (``padded_chain``), and its chain route (the
   chain formed in the kernel) bit-equal to that composition, repeatable
   and, at mode 0, bit-equal to its plain version on the CPU, timed beside
   the composition. Both chain routes' quantized variants (``psram=True``,
   the ``psram-stream`` backend's) on each mode's stream at full size:
   bit-equal to the plain chain (``cp_chain_psram`` on the card) folded by
   the route that adds in order (``psram_main``), repeatable, timed beside
   the exact chain on the same route, their plain versions and their bounds
   (bytes, f32 operations, and instructions counted from the source of
   today and of the first draft's true divisions); the ordered fold's launch
   must give every run of ``CHAIN_LONG_RUN`` nonzeros or more a cluster of
   8 CTAs (``layout``), and its head row's launch is timed alone; the
   instantiations' registers and spills from ``ptxas -v``; and small cases
   bit-equal to the CPU (``psram_small``), one with long runs. Kernel 6 at
   32k tokens and D = 128, at Gemma-2-9B's attention (``FLASH_D256``: D =
   256, softcap 50, bf16; the library timed without the softcap it does not
   take) and on the slab kernel (``FLASH_SLAB``: D = 512, f32), each beside
   its plain version, ``scaled_dot_product_attention`` and its bound, with
   each instantiation's ``ptxas`` registers and spills; small cases at D up
   to 512 in f32 and bf16. Kernel 2 with ``saturate=False`` on a planted
   full-scale element at granite-8b's q projection, 8 and 512 rows
   (``UNSAT_SHAPES``): bit-equal to its plain version, the element one code
   past the rail, timed beside ``saturate=True``.
4. ``main_path`` — the paths, each run with every launch counter set to 0
   just before it and read just after:
   a. ``cp_als(sparse=coo, rank=32, n_iter=3, backend="hopper")`` on the
      paper's array config and ``api.matmul`` at an LM MLP projection
      (512 x 4096 x 14336, kernel 2's wgmma route) and a 1000-class head
      (512 x 4096 x 1000, the tile route), each against ``backend="exact"``;
   a'. ``main_path_fit``: the same two engines on a tensor whose fit CP-ALS
      reaches (the power-law tensor's fits are ~0.002, so (a)'s gate cannot
      fail): a noiseless ``data.lowrank_dense`` tensor 240 x 160 x 100 of
      rank 16 through ``dense_to_coo``, 80 sweeps from one initial point;
      gated ``fit_exact >= 0.99`` and ``|fit_hopper - fit_exact| <= 0.02``,
      each fit equal to its factors' (``reconstruct``), and two planted
      controls that must read outside the gate: the hopper factors' mode-0
      rows rolled by one, and a hopper run missing 5% of the nonzeros;
   b. the dense entry point: ``api.mttkrp(x, factors, mode,
      backend="hopper")`` (kernel 4 reading the tensor in place, one
      launch a mode) and ``backends.get("hopper", compiled=False)`` for
      every mode of the dense tensor, against ``backend="exact"``; then one
      ``hopper`` call a mode split by operation under ``torch.profiler``
      (``hopper_split``) and its own peak device memory;
   c. ``cp_als`` on the sparse tensor with ``backends.get("hopper",
      compiled=False)`` (the blocked segment-sum stream on kernel 5's chain
      route, one launch a mode, its partials read in place by the ordered
      fold's fold route in their cached order), against the exact run of
      (a); then the blocked path on every mode twice: the same bits; one
      call a mode split by operation under ``torch.profiler`` with its own
      peak device memory (``legacy_split``: one fold launch, no gather of
      the partials); and the fold launch alone at each mode's shapes, the
      call's result bit-equal to the plain version on the CPU and to the
      route without ``order`` on the partials gathered first
      (``fold_route``).
   c'. ``main_path_psram_stream``: ``cp_als(sparse=coo, rank=32, n_iter=3,
      backend="psram-stream")`` on the paper's array (rows 256, ADC 16), then
      the same with ``compiled=True``: the ordered fold's quantized chain
      route once a mode, and kernel 5's quantized chain route + the fold
      route once a mode; the fits finite and within 1e-3 of each other; each
      mode's ``api.mttkrp`` (default backend: ``psram-stream``) and the
      compiled backend within ``rel_tol`` of exact, each call's own peak
      device memory below the (nnz, R) chain it never forms.
   c+. ``main_path_autotune``: ``cp_als`` (rank 32, 2 sweeps) on
      ``backends.get("hopper", autotune=True)`` from an empty winner cache,
      under tracing: each sweep's trials (``exec_blocks``, kernel 1's route,
      median ms) and winner (modes 0 and 1 share one key); a second call a
      mode makes no trial (``autotune/trials``); each tuned MTTKRP within
      ``rel_tol`` of exact and bit-equal to the untuned op forced to the
      winner's ``exec_blocks``; ``save_cache`` → ``clear_autotune_cache`` →
      ``load_cache`` gives the same winners without a sweep.
      ``main_path_mesh``: the ``psram-mesh`` backend at 4 arrays looped on
      the card: each lowering once a mode (``eager``: the ordered fold's
      quantized chain route a shard; ``compiled``: kernel 5's quantized
      chain route + the fold route a shard; ``fused``: kernel 1 a shard) and
      ``cp_als`` (3 sweeps, stamped a sweep) with the counts zeroed before
      and read after; the eager result bit-equal to the single-device
      ``psram-stream`` call, the others within ``rel_tol`` of exact, each
      lowering's call ms beside the single-device call's, each shard's nnz
      and the planner's imbalance, the fit against ``psram-stream``'s, the
      split Gram, the counted 4-array price equal to ``"analytical"``'s (the
      array's time beside the card's), the ``mesh4`` drift row and the
      executed plan's timeline.
   c''. ``main_path_schedule``: the array's tile schedule, plain PyTorch on
      the card (no hand-written kernel; every launch count 0). ``api.matmul``
      on its default backend, ``psram-scheduled``, at the MLP projection and
      the ragged head, eager and ``compiled=True`` (a CUDA graph captured
      on the first call and replayed): the two bit-equal and repeatable,
      each within ``rel_tol`` of exact, timed beside its bound (the padded
      f32 contraction at the f32 peak against the bytes) and
      ``torch._int_mm`` + ADC, each with its own peak memory; the executor
      on the card bit-equal to the CPU at a mid shape, a ragged one and a
      float64 one, and ``psram-oracle``'s per-cycle matmul on the card
      bit-equal to it; the dense ``psram-scheduled`` MTTKRP on every mode
      of the dense tensor against exact, timed, its own peak memory; the
      price: ``api.estimate`` of the §V workload (17.04 PetaOps) equal to
      ``psram-scheduled``'s counted breakdown, each mode of the sparse
      tensor priced on ``psram-stream`` from the raw COO, equal to
      ``stream_counts`` and to ``"analytical"``, the array's predicted time
      beside this card's measured ``psram-stream`` call and the H100
      roofline (labelled; no gain claimed); ``stream_mttkrp_priced`` at
      mode 2 bit-equal to that mode's ``psram-stream`` call (one counted
      launch of the ordered fold's quantized chain route).
   c'''. ``main_path_faults``: ``repro_torch.faults`` on the card (the
      scheduled matmul, the mesh stream on the ordered fold's quantized
      chain route, the group checksums on its fold route). ``abft_matmul``
      at the MLP projection on ``psram-scheduled``: clean (no site, ``y``
      bit-equal to ``execute``), then a stuck-MSB plan hitting tens of its
      448 N-tiles (detected, each recovered or taken by the fallback, within
      ``rel_tol`` of the clean run, recovery priced; the call's ms and the
      host seconds of its mask draw); the reference test's plan at 8 x 64 x
      96 on the card and the CPU (reports equal, ``y`` bit-equal);
      ``abft_mttkrp`` on mode 1 at 4 arrays, one root fiber a group, clean
      (``y`` bit-equal to the mesh call) and with transient spikes (what the
      detector saw, the error against the clean run); and
      ``degraded_mesh_mttkrp`` with array 1 of 4 lost, bit-equal to the
      clean mesh (its capacity, recovery cycles and chain launches).
   d. ``main_path_flash``: ``kernels.ops.flash_attention_op`` at its
      docstring's shape, a 32k-token causal prefill at granite-8b's
      attention widths (B=1, H=32, Hkv=8, D=128, bf16), and on layer 0's
      post-RoPE q/k/v of the served model below, against the model's own
      attention and (one-ulp envelope) against the kernel's plain version;
   d'. ``main_path_flash_wide``: the same entry point at ``FLASH_D256``
      (one launch of the bf16 kernel at D = 256) and ``FLASH_SLAB`` (one
      launch of the slab kernel); after the exact serve below,
      ``blocks.group_decode`` on its group 0 (``group_decode_case``: the
      cache it writes in place bit-equal to ``group_decode_tokens`` +
      ``apply_decode_deltas``, its output within ``GROUP_DECODE_TOL``);
   e. ``main_path_serve``: granite-8b at full width and depth (36 layers,
      bf16, 8.25 B random parameters seeded on the card) through
      ``ServeEngine.generate`` on 8 prompts x 1024 tokens, 64 new tokens,
      greedy — then the same with ``psram_projections`` and
      ``psram_stored_int8`` (every projection through kernel 2: the wgmma
      route in a prefill, the decode route in a decode step). Each run
   also profiles 8 decode steps and one prefill (device busy time, idle
   share, kernel 2's ms and launches, top kernels); kernel 2 is held
   bit-equal to its plain version on the operands layer 0's seven
   projections give it in a prefill (and to the tile route) and a decode
   step, and every decode projection of 16 greedy tokens is held bit-equal
   to the tile route on the same operands.
   e'. ``main_path_moe``: granite-moe-1b-a400m at full width and depth (24
      layers, 32 experts top-8, bf16, 1.385 B random parameters) served the
      same way, exact and pSRAM (attention projections through kernel 2,
      the experts through ``psram_einsum``): prefill ms, decode ms a step,
      tokens/s, launches a step, the share of assignments the capacity
      drops; the pSRAM prefill against an exact prefill on the dequantized
      words (< 0.5), the first decode step against ``forward`` on a dropless
      replica (relative L2 <= 0.05), ``psram_einsum`` bit-equal to kernel 2
      run on each expert on layer 0's served buffers, and kernel 2 on every
      attention projection (the wgmma route in the prefill, the decode route
      in a step). dbrx-132b (131.6 B parameters) does not fit one card.
   e''. the other families, each with the counts zeroed before its
      ``generate`` and read after, as above: ``main_path_ssm`` serves
      mamba2-370m at full width and depth (48 SSD layers, bf16, random
      weights) on 8 prompts x 1024 tokens, 64 new, exact and pSRAM
      (``in_proj`` and ``out_proj`` through kernel 2: the wgmma route in a
      prefill, the decode route in a step): the SSD scan's share of a
      prefill (CUDA events around each call), the exact run's first
      recurrent step against the chunked ``forward`` (relative L2 <= 0.05),
      kernel 2 bit-equal to its plain version on layer 0's served operands
      (N = 4384 at M = 8192, 24 and 8), each pSRAM layer's own error against
      its dequantized words (< 0.06, split by projection, with two wrong-
      projection controls that must read above it; the end-to-end pSRAM
      distances are reported, not gated: 48 gated layers amplify int8
      noise), and ``ssd_chunked`` at one layer's served shape on the card
      within 1e-5 of max |y| of the CPU, timed beside its bound. ``main_path_encdec`` serves
      seamless-m4t-large-v2 at full width and depth (24 + 24 layers) through
      ``generate(frames=)``: stub frames 8 x 1024 x 1024, decoder prompts of
      256 tokens, 64 new, exact and pSRAM (every projection but the frame
      projection and the head through kernel 2), the encode timed alone,
      the first step against ``forward``, the pSRAM prefill against the
      dequantized words (< 0.5) and kernel 2 bit-equal to its plain version
      on the first encoder and decoder layers' served operands.
      ``main_path_mrope`` serves qwen2-vl-7b at full width, its depth cut
      to 4 layers (the script's time; M-RoPE is an elementwise change of
      the dense path run at full depth above), 16 new tokens, exact, and
      holds ``apply_rope`` with three distinct position streams on layer
      0's served q on the card against the CPU (the angles bit-equal, the
      output within what one bf16 ulp of cos and sin moves it).
      jamba-1.5-large does not fit one card (one group of 8 layers is ~44 B
      parameters): CPU and ``cuda`` tests at ``reduced()`` only.
   e+. ``main_path_paged``: granite-8b at full width and depth through the
      paged serve loop (``ServeLoop``: 4096 pages of 16 slots, 8 decode
      rows) on a live bursty stream of 32 requests (prompts 32..1024,
      decodes 8..64), exact and then with every projection through kernel 2,
      each after one ``warmup``, the counts zeroed before the stream and
      read after: each run's summary (latency and TTFT percentiles, tokens/s,
      measured beside modeled step seconds), a few profiled decode steps of
      8 rows at mixed lengths (idle, launches, the gather's and scatter's
      device ms, the step's own peak memory), a prefill's ms by bucket;
      gated on no leaked page, every request accounted for, no failure
      without a limit, each row of the paged step within 0.05 of the dense
      step on the same rows (and a planted fault's row above it: the
      check's control), the mask hiding every stale slot bit for bit,
      kernel 2's launches by route and its bits on layer 0's calls in paged
      prefills and a paged step. The share of greedy tokens equal to
      ``generate`` at batch 1 is reported. Then 12 requests (decodes
      cut to 16 tokens) at once on just more pages than the largest needs:
      preemptions, no leak.
   f. ``main_path_trace``: ``repro_torch.obs`` on the card. With tracing
      enabled, ``cp_als`` (rank 32, 3 sweeps) on ``hopper``, ``hopper`` with
      ``compiled=False`` and ``psram-stream`` eager and compiled: each run's
      ``obs.summary()`` and each sweep split in place into its three
      ``backend/<name>/mttkrp`` spans, three ``gram`` spans, the remainder no
      child span covers and the ``als/fit`` span; each traced run bit-equal
      to an untraced one. The stopwatch around 5 dense ``hopper`` calls at
      mode 0 within 10% + 0.1 ms of CUDA events on the same calls (a host
      clock without the synchronize beside them), after one discarded case,
      each case's host time at both edges reported; a CUDA graph capture of
      ``api.matmul`` on ``psram-scheduled`` under tracing, bit-equal to the
      eager call; ``drift_report().max_drift == 0``; the mesh timeline of
      mode 0's fiber lengths on 4 arrays, each array's slices ending at its
      planned program's counted cycles and the all-reduce at the largest;
      the trace written and read back (``cat`` the name's first segment, the
      ``stream/nonzeros`` counter the sum of the streamed calls' nnz); the
      median of 5 warm ``hopper`` sweeps untraced and traced. The tracer is
      left disabled and empty.
5. ``sweep_time`` — one warm sweep of each CP-ALS engine (``hopper`` fused
   and ``compiled=False``, ``exact``, ``psram-stream`` eager and compiled),
   beside the traced split of the same backends, and the parts of a
   ``hopper`` sweep timed alone.
6. ``main_path_train`` — training on the card: granite-8b at full width
   (bf16, d 4096, ff 14336, vocab 49152), its depth cut to 8 of 36 layers
   (AdamW's state is 16 B a parameter: the whole model's ~132 GB does not
   fit 80 GB), chunked attention and remat (``"dots"``), as the reference
   trains; ``Trainer`` on the port's data stream, batch 4 x 1024 tokens, 24
   steps of AdamW, the counts zeroed before and read after (no hand-written
   kernel is on this path; every count must read 0): the losses (finite,
   the last 5 steps' mean under the first 5's by 1.0), ms a step, tokens/s,
   ``6 N T / t`` beside the bf16 peak (labelled, no gain claimed),
   stragglers, peak memory beside the reckoned state, one step under
   ``torch.profiler``; then 3 steps with error feedback at the same size;
   then at ``reduced()`` (f32) a train step on the card against the CPU and
   a checkpoint resume on the card, bit-equal.

7. ``main_path_dist`` — sharding, the model meshes and the dry run
   (``repro_torch.dist.sharding``, ``launch.dryrun``): the meta dry run of
   granite-8b's applicable shapes and mamba2-370m's ``long_500k`` on both
   production meshes (each row OK with FLOPs and bytes > 0, or SKIP with
   its reason); card cell A, granite-8b ``decode_32k`` exact at full width
   and depth on the 1x1 card mesh, its global batch cut 128 -> 4 (the
   spec-derived argument bytes equal to the allocated tensors' bytes, the
   FLOPs counted on the card equal to the meta count of the same cell;
   median step ms, peak bytes, ``ideal_s``, ``measured_fraction``); card
   cell B, granite-8b ``train_4k`` through pSRAM projections at full width,
   8 of 36 layers, global batch 256 -> 2 in 2 microbatches, 3 steps of
   AdamW at lr 3e-4 without warmup (finite losses, the last under the
   first; kernel 2's launches by route equal to the derived forward, remat
   recompute and backward; on layer 0's calls kernel 2's autograd gradients
   bit-equal to the plain version's on the card), then at ``reduced()``
   (f32) a pSRAM train step on the card against the CPU, update included,
   with the exact step's tolerances; ``ServeEngine`` on the
   card mesh with ``--seq-shard``'s rules at full width, 4 layers (tokens
   and prefill logits bit-equal to ``mesh=None``); ``partition_csf`` on a
   4-array card mesh equal to ``n_arrays=4``.

8. ``main_path_examples`` — every example of ``repro_torch.examples`` run
   in this process on the card through its ``main`` (at the reference CI's
   ``--smoke`` size where the script has one, ``decompose_weights`` on 8
   arrays, ``train_lm`` 50 steps), the counts zeroed before each and read
   after: its seconds, the device of a tensor it computed, its figures, its
   printed lines, its hand-written launches, and the whole script's seconds
   so far. Fails when an example raises (each asserts its own contract: a
   row over its ``rel_tol``, a leaked page, a missed restart step, an
   inexact degraded recovery) or leaves the card, photonic_offload's kernel
   2 is not bit-exact against the oracle or was not launched, backend_tour's
   ``hopper`` row launched no kernel, ABFT's corrected error is not 0, or
   the phase takes over 120 s.

9. ``main_path_multicard`` — granite-8b (4 layers) as DTensors on a
   world-1 NCCL group, exact and pSRAM, bit-equal to ``mesh=None``; the
   pSRAM run's row-parallel projections must launch the int32 ``wgmma``
   slice in a prefill and the slice that quantizes its own rows in each
   decode step (the int32 decode route never). ``psram_linear(saturate=
   False)`` on the planted full-scale operands at ``UNSAT_SHAPES`` with the
   weight row-parallel on the world-1 mesh (the K split's sums + the
   epilogue launched with no clip) bit-equal to its plain version. Then
   ``split_cases``: the
   bf16 rows' quotient held to ``__fdiv_rn`` for every bf16 value and scale,
   kernel 2 with K split 4 ways at o's and down's K (every route and the
   rows slice, bit-equal to the fused kernel and its plain version; the
   epilogue in f32 and bf16), the projection split by operation (each
   launch's device and eager ms, the parent's composition beside this
   one's) and the ``wgmma`` route at the paged loop's prefill rows.
   ``--split-only`` runs the build and ``split_cases`` alone;
   ``--cards 4`` the four-card run alone.

TF32 is switched off for matmuls and cuDNN before anything runs: the plain
versions of the dense MTTKRP and flash kernels are f32 matrix products.

Output: one JSON object per line (each phase's with its wall seconds,
``phase_wall_s``); the ``kernels`` line, the card's name and
power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

NELL2_SHAPE = (12092, 9184, 28818)       # FROSTT NELL-2 dimensions
RANK = 32                                # the paper's §V operating point
SWEEPS = 3
MLP_SHAPE = (512, 4096, 14336)           # x (512, d_model) @ w (d_model, d_ff)
# a 1000-class head on the same activations: N % 16 = 8, which TMA cannot
# take, so kernel 2's mma.sync tile route
RAGGED_SHAPE = (512, 4096, 1000)
DENSE_SHAPE = (1024, 768, 1152)          # 3.62 GB of f32; every mode % 128 == 0
FLASH_MAIN = (1, 32, 8, 32768, 128)      # (B, H, Hkv, S, D): prefill_32k at granite-8b's widths
# Gemma-2-9B's attention (google/gemma-2-9b config.json: 16 query heads, 8
# kv heads, head_dim 256, attn_logit_softcapping 50, query_pre_attn_scalar
# 256 so the scale is D^-1/2, 8192 positions): kernel 6 at D = 256
FLASH_D256 = (1, 16, 8, 8192, 256)
FLASH_D256_SOFTCAP = 50.0
# the slab kernel (D > 256) at Gemma-2-9B's heads and positions with D = 512,
# a head dim no configuration of the repo has
FLASH_SLAB = (1, 16, 8, 8192, 512)
# kernel 2 with saturate=False at granite-8b's q projection (d_model 4096 ->
# q_dim 4096), a decode step's rows (the decode route) and a prefill's (wgmma)
UNSAT_SHAPES = ((8, 4096, 4096), (512, 4096, 4096))
# group_decode on the card: a seeded cache of this many slots, written at
# GROUP_DECODE_POS; its output within GROUP_DECODE_TOL of max |x| of the
# read-only decode's (see group_decode_case)
GROUP_DECODE_CACHE, GROUP_DECODE_POS, GROUP_DECODE_TOL = 64, 40, 2e-2
SERVE_ARCH = "granite_8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 1024, 64
# granite-8b's decode projections at M = SERVE_BATCH rows: q/o, k/v, wi/wg, down
DECODE_SHAPES = ((8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336), (8, 14336, 4096))
# the same projections in a prefill, M = SERVE_BATCH * SERVE_PROMPT rows
PREFILL_SHAPES = tuple((SERVE_BATCH * SERVE_PROMPT, k, n) for _, k, n in DECODE_SHAPES)
# the wgmma route with one 128-deep stage: its fill and epilogue alone
EPILOGUE_SHAPE = (8192, 128, 14336)
CROSSOVER_M = (1, 2, 4, 8, 16, 32, 64)    # --tuning; by default the ends of the decode range
CROSSOVER_M_DEFAULT = (1, 16)
# eager launches a pSRAM decode step made on the tile route; the decode route
# must not add any
PSRAM_DECODE_LAUNCH_CEILING = 6529
TOKENS_CHECKED = 16                       # greedy tokens compared across kernel 2's routes
CROSSOVER_KN = ((4096, 14336), (4096, 1024))
# main_path_trace: the api.matmul shape captured under tracing (no earlier
# phase captures it), the dense calls inside one stopwatch, the arrays of the
# mesh timeline and its event budget, the sweeps of the overhead figure
TRACE_CAPTURE_SHAPE = (256, 4096, 4096)
STOPWATCH_CALLS = 5
MESH_ARRAYS, MESH_EVENTS = 4, 10_000
OVERHEAD_SWEEPS = 5
# main_path_autotune: the tuned CP-ALS run's sweeps; main_path_mesh: the
# arrays looped on the one card
TUNE_SWEEPS = 2
MESH_MAIN_ARRAYS = 4
# main_path_faults: the stuck-MSB rate that puts stuck cells in ~73% of the
# MLP matmul's 448 N-tiles (131,072 stored words a tile), of which the
# detector flags tens (a single stuck word at K = 4096 mostly stays under
# its threshold); the transient spike rate on the sparse stream (~34 of
# 16.76 M nonzeros) and the root fibers a checksum group (one: a
# ~1,800-nonzero group of mode 1 sees a spike of twice the largest value; 16
# groups of ~1 M nonzeros would not)
FAULT_STUCK_RATE = 1e-5
FAULT_SPIKE_RATE = 2e-6
FAULT_GROUP_FIBERS = 1
# main_path_moe: the MoE family served at full width and depth
MOE_ARCH = "granite_moe_1b_a400m"
# main_path_ssm / main_path_encdec / main_path_mrope: the SSM family at full
# width and depth; the encoder-decoder at full width and depth, its decoder
# prompt a quarter of the frames (the reference's ENC_DEC_FRAC,
# src/repro/launch/shapes.py:36); M-RoPE at full width, its depth cut to 4
# layers for the script's time (M-RoPE is an elementwise change of the dense
# path that main_path_serve runs at full depth), 16 new tokens
SSM_ARCH = "mamba2_370m"
ENCDEC_ARCH = "seamless_m4t_large_v2"
ENC_DEC_FRAC = 0.25
MROPE_ARCH = "qwen2_vl_7b"
MROPE_LAYERS = 4
MROPE_NEW = 16
# ssd_chunked on the card against the same inputs on the CPU, of max |y|
SSD_TOL = 1e-5
# a pSRAM mamba2 layer's own error against its dequantized words (relative
# L2 of its residual branch from the same input). At full width on a CPU
# (one layer, 2 x 256 tokens) it is 0.044: out_proj 0.040 of it (0.034 its
# int8 activations alone, the rest its 16-bit ADC over K = 2048), in_proj
# 0.018. out_proj's input, the gated y * silu(z) after its norm, has a crest
# factor (max |row| / RMS) of ~14 against in_proj's ~3.4, so an int8 row's
# step is ~14 / 127 of its RMS: ~3% noise, not the ~0.7% of a Gaussian row.
# Controls (ssm_error_split): in_proj's dt columns zeroed read 0.31, out_proj
# off by 10% reads 0.11; a sound layer read at most 0.047 on an H100
MAMBA_LAYER_OWN_TOL = 0.06
# decode steps profiled in each of those three phases (8 in the others): with
# 8, the profiler's windows took 102 s of the three phases' 135 s on an H100
NEW_FAMILY_PROFILED_STEPS = 4
# main_path_paged: granite-8b at full width and depth through the paged serve
# loop (ServeLoop): 4096 pages of 16 token slots (65,536 slots, 9.66 GB of
# bf16 KV beside the 16.5 GB of weights), 8 decode rows, one bursty stream
# of 32 requests (prompts 32..1024, Pareto tail 1.8; decodes 8..64, tail
# 1.5) released live (speedup 1), exact and with every projection through
# kernel 2; then the same stream's first 12 requests, their decodes cut to
# 16 tokens for the script's time (under pressure the rows run mostly one
# at a time), all at once, exact, on just more pages than the largest
# request needs (page pressure: preemptions)
PAGED_LOOP = {"max_batch": 8, "page_size": 16, "num_pages": 4096}
PAGED_TRAFFIC = {"n_requests": 32, "seed": 0, "arrival": "bursty", "rate_rps": 8.0,
                 "burst_factor": 8.0, "prompt_min": 32, "prompt_max": 1024,
                 "prompt_tail": 1.8, "decode_min": 8, "decode_max": 64,
                 "decode_tail": 1.5, "vocab_size": 49152}
PAGED_PRESSURE = {"n_requests": 12, "decode_max": 16}
PAGED_PROFILED_STEPS = 4
PAGED_TOKENS_CHECKED = 8                  # completed requests held against generate at batch 1
# a paged step vs the dense step, relative L2 of each row: over the whole
# step, one row's one-slot fault reads 0.0497 on an H100 (paged_vs_dense)
PAGED_STEP_TOL = 0.05
PAGED_POISON = 64.0                       # what fills the slots a step must not read
# main_path_train: granite-8b at full width trained by Trainer, its depth cut
# so AdamW's state (16 B a parameter: bf16 weights and grads, f32 master, m
# and v) fits the card: 8 layers are ~2.15 B parameters, ~34 GB of state
TRAIN_ARCH = "granite_8b"
TRAIN_LAYERS = 8
TRAIN_DATA = {"seq_len": 1024, "global_batch": 4, "seed": 0}
TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 5, "total_steps": 100}
TRAIN_STEPS = 24
TRAIN_LOSS_DROP = 1.0                     # the last 5 steps' mean loss under the first 5's by this
TRAIN_EF_STEPS = 3
TRAIN_SMALL_DATA = {"seq_len": 64, "global_batch": 4, "seed": 1}
TRAIN_RESUME_STEPS = 10

# main_path_dist: the meta dry run's cells, and the card cells' cuts (depth
# and global batch) so the cells fit 80 GB: cell A's ~16 GB of weights and
# ~19.3 GB of KV cache; cell B's 8 layers as main_path_train's
DIST_ARCH = "granite_8b"
DIST_META_CELLS = (("granite_8b", ("train_4k", "prefill_32k", "decode_32k", "long_500k")),
                   ("mamba2_370m", ("long_500k",)))
DIST_DECODE_BATCH = 4                     # decode_32k's global batch 128 cut to 4
DIST_DECODE_REPEATS = 5
DIST_TRAIN_LAYERS = 8
DIST_TRAIN_BATCH = 2                      # train_4k's global batch 256 cut to 2
DIST_TRAIN_MICROBATCHES = 2
DIST_TRAIN_STEPS = 3
# cell B's AdamW: no warmup, so each of its steps updates at lr 3e-4 and the
# loss on its one batch must fall from the first step to the last
DIST_TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 0, "total_steps": 100}
DIST_SERVE_LAYERS = 4
DIST_SERVE = {"batch": 2, "prompt_len": 16, "max_new": 8}
DIST_MESH_ARRAYS = 4

# main_path_multicard: placement across ranks. On one card (the default
# run) a world-size-1 NCCL group: granite-8b at full width, its depth cut to
# MULTI_LAYERS, as DTensors on a 1 x 1 DeviceMesh, exact and pSRAM, against
# mesh=None; kernel 2's int32-out routes + the epilogue launch over a
# SPLIT_WAYS-way K split at o's and down's K, decode and prefill rows
MULTI_ARCH = "granite_8b"
MULTI_LAYERS = 4
MULTI_SERVE = {"batch": 8, "prompt_len": 256, "max_new": 8}
SPLIT_WAYS = 4
SPLIT_SHAPES = ((8, 4096, 4096), (8, 14336, 4096), (2048, 4096, 4096), (2048, 14336, 4096))
# the rows slice's layouts timed by --tuning / --split-only: (M, K slice, N)
# at granite-8b's o and down and dbrx-132b's o over 4 cards
ROWS_TUNE_SHAPES = ((8, 1024, 4096), (8, 3584, 4096), (8, 1536, 6144), (16, 1024, 4096))
# kernel 2's wgmma route at the paged loop's prefill rows, q/o and gate/up
PAGED_PREFILL_SHAPES = tuple((m, 4096, n) for m in (64, 128, 256) for n in (4096, 14336))
# --cards 4: four ranks, one a card, NCCL over NVLink
CARDS = 4
FOUR_DBRX = {"batch": 4, "prompt_len": 128, "max_new": 16}
FOUR_DBRX_SHORT_LAYERS = 2                # the depth held against one card
FOUR_GRANITE = {"batch": 4, "prompt_len": 128, "max_new": 8}
FOUR_TRAIN = {"seq_len": 1024, "global_batch": 8, "seed": 0}
FOUR_TRAIN_STEPS = 12
FOUR_CKPT_LAYERS = 2                      # f32, FOUR_CMP_STEPS steps against one card
FOUR_CMP_STEPS = 2
FOUR_STEP_TOL = 0.05                      # dbrx depth 2, first step, relative L2 vs one card

# main_path_fit: CP-ALS on a tensor whose fit it can reach (the NELL-2-shaped
# power-law tensor's fits are ~0.002, so its gate cannot fail): a noiseless
# lowrank_dense tensor of 3.84 M entries, non-cubic, rank 16 (kernel 1's
# chunk route), through dense_to_coo; the gate wants fit_exact >= 0.99 and
# hopper within 0.02 of it, and two planted controls must read outside it:
# the hopper factors' mode-0 rows rolled by one (on an H100: exact 0.998620,
# hopper 0.995890, the control 0.746176) and a hopper run that never sees
# FIT_DROP of the nonzeros
FIT_SHAPE = (240, 160, 100)
FIT_RANK = 16
FIT_SWEEPS = 80
FIT_MIN = 0.99
FIT_GAP = 0.02
FIT_DROP = 0.05    # the share of nonzeros the second planted control never sees
# main_path_examples: every example of repro_torch.examples on the card, at
# the reference CI's --smoke size where the script has one (decompose_weights
# also at its 8 arrays), else its default; train_lm at 50 steps (its default
# 300 would take most of the phase's 120 s)
EXAMPLE_ARGS = (("quickstart", ()), ("backend_tour", ()), ("sparse_decompose", ()),
                ("decompose_weights", ("--smoke", "--arrays", "8")),
                ("photonic_offload", ()), ("fault_tolerance", ("--smoke",)),
                ("serve_requests", ("--smoke",)), ("continuous_batching", ()),
                ("train_lm", ("--steps", "50")))
EXAMPLES_BUDGET_S = 120.0

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates): the
# port's roofline constants, one source for both
from repro_torch.core.perf_model import (  # noqa: E402
    H100_BF16_FLOPS_PER_S as BF16_FLOPS_PER_S,
    H100_F32_FLOPS_PER_S as F32_FLOPS_PER_S,
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    H100_INT8_OPS_PER_S as INT8_OPS_PER_S,
)

# cycles between two dependent f32 adds on an SM, the chain floor's unit (an
# assumption: Hopper's FADD latency is not published)
FADD_CYCLES = 4
# one f32 instruction a lane a cycle: the f32 peak counts an FMA as two
F32_INSTRUCTIONS_PER_S = F32_FLOPS_PER_S / 2
# instructions of one IEEE f32 division (__fdiv_rn) on its fast path: the
# reciprocal, its Newton steps and the range check (an assumption: the SASS
# is not counted)
FDIV_INSTRUCTIONS = 8
# CTAs of the cluster a long run of the quantized chain route takes
# (csrc/ordered_fold.cu's CLUSTER, the portable size)
CHAIN_CLUSTER = 8


_LAST_EMIT = [time.perf_counter()]
_START = [time.perf_counter()]


def emit(obj: dict) -> None:
    """Print ``obj`` as one JSON line; a phase's object first gets the wall
    seconds since the previous line (``phase_wall_s``)."""
    now = time.perf_counter()
    if "phase" in obj:
        obj["phase_wall_s"] = now - _LAST_EMIT[0]
    _LAST_EMIT[0] = now
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sass_counts(libs: dict) -> dict:
    """Per built library, how many Hopper warpgroup MMAs (``HGMMA`` float,
    ``IGMMA`` integer), TMA loads (``UTMALDG``) and warp-level MMAs (``HMMA``
    float, ``IMMA`` integer) its SASS holds, by ``cuobjdump -sass`` from
    nvcc's directory; None where it is missing."""
    from repro_torch.kernels import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    counts = {}
    for name, path in libs.items():
        sass = subprocess.run([str(tool), "-sass", str(path)], check=True, capture_output=True,
                              text=True, timeout=300).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                        for op in ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")}
    return counts


def time_ms(torch, fn, warmup: int = 2, iters: int = 5, reps: int = 4) -> float:
    """Median milliseconds per call of ``fn`` by CUDA events: after a
    warm-up, ``iters`` timings of ``reps`` back-to-back calls each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def graph_ms(torch, fns, reps: int = 1, iters: int = 5) -> float:
    """Device milliseconds per call, host out of the way: the calls ``fns``
    (each ``reps`` times, in turn) captured in one CUDA graph, the graph
    replayed ``iters`` times, the median replay over the number of calls.
    Handing ``fns`` that cycle over copies of an operand larger than the
    50 MB L2 times the calls cold, as the served decode step finds its
    weights."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:                       # warm-up: builds, allocations
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / (reps * len(fns)))
    del graph
    return statistics.median(times)


def pass_split(torch, fn, ms: float, n: int = 5, attempts: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` by operation: ``n`` calls under
    ``torch.profiler``, each kernel's (or memset's) device time summed by its
    name and divided by ``n``. ``ms`` is the call's time by CUDA events: a
    window whose operations add up to less than 0.8 of it lost records and
    is profiled again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        split: dict = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            kernel = re.search(r"\b(\w+_kernel)\b", e.key)
            name = "memset" if "memset" in e.key.lower() else (kernel[1] if kernel else e.key[:40])
            us = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            split[name] = split.get(name, 0.0) + us / 1e3 / n
        if sum(split.values()) >= 0.8 * ms:
            return split
    raise AssertionError(f"the profiler saw {split} of a {ms} ms call")


def call_split(torch, fn, fold_launches: int, n: int = 3, attempts: int = 3) -> dict:
    """One whole call of ``fn`` split three ways: device time of the ordered
    fold's kernels (``fold_ms``: every kernel named ``ordered_*``), device
    time of every other kernel, copy and memset (``other_ms``: the chain's
    casts, gathers and products where the call forms them eagerly), and the
    rest of the call's CUDA-event time, when the card waited on the host
    (``idle_ms``); with the launches of each. ``n`` calls under
    ``torch.profiler`` after one warm call; a window that did not record
    ``fold_launches`` fold launches a call lost records and is profiled
    again, and the run fails where every attempt did (as :func:`pass_split`
    does), since the lost records' time would read as idle."""
    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(torch, fn, warmup=1, iters=3, reps=1)
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        fold_ms = other_ms = fold_n = other_n = 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            if "ordered_" in e.key:
                fold_ms, fold_n = fold_ms + us / 1e3 / n, fold_n + e.count / n
            else:
                other_ms, other_n = other_ms + us / 1e3 / n, other_n + e.count / n
        if fold_n == fold_launches:
            return {"ms": ms, "device_ms": fold_ms + other_ms, "fold_ms": fold_ms,
                    "other_ms": other_ms, "idle_ms": ms - fold_ms - other_ms,
                    "fold_launches": fold_n, "other_launches": other_n, "attempts": attempt}
    raise AssertionError(f"the profiler saw {fold_n} of {fold_launches} fold launches a call "
                         f"in each of {attempts} windows")


# host seconds between a profile's warm calls and its window
PROFILE_PAUSE_S = 1e-2
# whole calls a profile makes before its window: the first records of a
# profile can be lost, one call's worth or more (all 3 launches of a
# blocked sparse MTTKRP's warm call and the window's first, in each of 5
# windows of one run)
PROFILE_WARM_CALLS = 3
#: the CUDA runtime and driver calls that launch or enqueue device work; the
#: profiler gives each the correlation id of the kernel, memset or copy it made
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]\w*$")


def op_split(torch, fn, own: str, n: int = 3, attempts: int = 5) -> dict:
    """One whole call of ``fn`` split by operation: the device time of each
    kernel whose name matches ``own`` (the repository's kernels) under that
    name, and of every other kernel under the outermost ``aten::`` op that
    launched it; the card's busy time, and the rest of the call's CUDA-event
    time (``idle_ms``), with the launches of each, per call (device time the
    profiler tied to no op is ``unattributed``). ``n`` calls under
    ``torch.profiler`` after ``PROFILE_WARM_CALLS`` warm calls; the
    window's kernels are those whose runtime call was made in it
    (``early_records``: how many of them the device clock put before its
    start). A window that recorded no
    kernel, or in which some kernel's launches are not a multiple of ``n``,
    lost records and is profiled again; the run fails where every attempt
    did."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    mine = re.compile(rf"\b({own})\b")
    ms = time_ms(torch, fn, warmup=1, iters=3, reps=1)
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a profile's first kernel records can be lost (the eager
            # quantization's first abs launch in every window; late in the
            # script, the first three launches of each window, ~4.5 ms; one
            # run lost four of a blocked sparse MTTKRP's): whole warm calls
            # and a pause, outside the window, take their place
            for _ in range(PROFILE_WARM_CALLS):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
            with record_function("split_calls"):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        t0 = next(e for e in events
                  if e.name == "split_calls" and e.device_type != cuda).time_range.start
        # a kernel belongs to the window where the runtime call that launched
        # it does (the same correlation id, on the host's clock): the device
        # clock the profiler maps kernels onto can lag the host's, and a
        # window's first kernel, launched microseconds after t0, then read as
        # before it (each mode's first window in 4c, and all 5 of one run)
        launch_us = {e.id: e.time_range.start for e in events
                     if e.device_type != cuda and RUNTIME_CALL.match(e.name)}
        device = [e for e in events if e.device_type == cuda and e.name != "split_calls"
                  and launch_us.get(e.id, e.time_range.start) >= t0]
        early = sum(e.time_range.start < t0 for e in device)
        events = [e for e in events if e.device_type != cuda
                  and e.time_range.start >= t0 and e.name != "split_calls"] + device
        busy_us = sum(e.time_range.end - e.time_range.start for e in device)
        ops: dict = {}

        def add(label, us):
            entry = ops.setdefault(label, {"ms": 0.0, "launches": 0.0})
            entry["ms"] += us / 1e3 / n
            entry["launches"] += 1 / n

        for e in device:                     # the repository's own kernels
            hit = mine.search(e.name)
            if hit:
                add(hit[1], e.time_range.end - e.time_range.start)
        for e in events:                     # PyTorch's, under the op that asked
            if e.device_type == cuda or not e.kernels:
                continue
            top = e
            while top.cpu_parent is not None and top.cpu_parent.name.startswith("aten::"):
                top = top.cpu_parent
            for k in e.kernels:
                if not mine.search(k.name):
                    add(top.name, k.duration)
        counts = {}
        for e in device:
            counts[e.name] = counts.get(e.name, 0) + 1
        if device and all(c % n == 0 for c in counts.values()):
            busy_ms = busy_us / 1e3 / n
            rest = busy_ms - sum(v["ms"] for v in ops.values())
            if abs(rest) > 1e-3 * busy_ms:   # kernels the profiler tied to no op
                ops["unattributed"] = {"ms": rest, "launches": None}
            return {"ms": ms, "busy_ms": busy_ms, "idle_ms": ms - busy_ms,
                    "launches": len(device) / n, "ops": ops, "attempts": attempt,
                    "early_records": early}
    raise AssertionError(f"the profiler lost records of a call in each of {attempts} "
                         f"windows: {ops}, {counts}")


#: the parts of a blocked (``compiled=False``) sparse MTTKRP, by the kernels
#: and ``aten::`` ops :func:`op_split` names
LEGACY_PARTS = {
    "chain": ("aten::index", "aten::to", "aten::_to_copy", "aten::mul"),  # gathers, casts, products
    "kernel5": ("segment_sum_kernel", "segment_chain_kernel"),
    "zeros": ("aten::zeros", "aten::zero_", "aten::fill_"),
    "index_select": ("aten::index_select",),
    "fold": ("ordered_fold_kernel",),
}


def legacy_split(torch, fn) -> dict:
    """One ``stream_mttkrp_blocked`` call by operation (:func:`op_split`),
    each op also counted in its part of :data:`LEGACY_PARTS` (``other``: the
    rest), and the device memory the call alone takes beyond what was held
    before it (:func:`call_bytes_peak`)."""
    split = op_split(torch, fn, r"segment_\w+_kernel|ordered_\w+_kernel")
    parts = {name: {"ms": 0.0, "launches": 0.0} for name in (*LEGACY_PARTS, "other")}
    for op, v in split["ops"].items():
        name = next((k for k, ops in LEGACY_PARTS.items() if op in ops), "other")
        parts[name]["ms"] += v["ms"]
        parts[name]["launches"] += v["launches"] or 0.0
    return {**split, "parts": parts, "call_bytes_peak": call_bytes_peak(torch, fn)}


def call_bytes_peak(torch, fn) -> int:
    """The device memory one call of ``fn`` takes beyond what was held
    before it: ``max_memory_allocated`` over the call less what was
    allocated before it."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def legacy_fold_case(torch, csf, factors, cfg) -> dict:
    """The fold route at one mode of the main path, on the partials a
    ``stream_mttkrp_blocked`` call folds: the call's result bit-equal to its
    plain version on the CPU (``index_select`` + ``index_add_``, which adds
    in stream order) and to the route without ``order`` on the partials
    gathered first (``index_select``); the launch alone (the partials as
    kernel 5 left them, warm in L2) at the default ``FOLD_LONG_RUN`` and at
    other thresholds, as device times of calls in a CUDA graph (``graph_ms``;
    ``eager_ms``: back-to-back eager calls, which the host paces); its byte
    bound (the P partial rows it reads, the order and the runs read once,
    ``out`` read and written once); its plain version (on the card
    ``index_add_`` is atomic) and the library call on the gathered rows
    (``index_add_``, the gather not counted); and the runs' lengths."""
    from repro_torch.kernels import ordered_fold as of
    from repro_torch.kernels.ops import blocked_chain_segment_sum_op
    from repro_torch.sparse.stream import _chain_stream, _segment_blocks, stream_mttkrp_blocked

    mode = csf.mode_order[0]
    fs = tuple(f.contiguous() for f in factors)
    local, n_seg, order, fold_rows, fold_runs, _ = _segment_blocks(csf, cfg.rows)
    coords = _chain_stream(csf)[0]
    partials = blocked_chain_segment_sum_op(coords, csf.values, local, fs, mode, n_seg)
    rows, rank = csf.shape[mode], partials.shape[-1]
    d = partials.reshape(-1, rank)
    zeros = lambda: torch.zeros((rows, rank), device="cuda")
    got = stream_mttkrp_blocked(csf, fs, cfg)
    gathered = d.index_select(0, order)
    lengths = fold_runs.diff()
    case = {
        "mode": mode, "rows": rows, "partial_slots": d.shape[0], "folded": order.numel(),
        "nonempty_rows": int((lengths > 0).sum()), "longest_run": int(lengths.max()),
        "long_runs": int((lengths > of.FOLD_LONG_RUN).sum()),
        "bit_equal_to_cpu": bool(torch.equal(got.cpu(), of.ordered_fold_torch(
            zeros().cpu(), d.cpu(), fold_rows.cpu(), order=order.cpu()))),
        "bit_equal_to_gathered": bool(torch.equal(
            got, of.ordered_fold(zeros(), gathered, fold_rows, runs=fold_runs))),
    }
    buf = zeros()
    runs_host = fold_runs.cpu()
    long_at = {t: torch.as_tensor(of.find_long_runs(runs_host, t), device="cuda")
               for t in (of.FOLD_LONG_RUN, 16, 256, 1024, 1 << 40)}
    launch = lambda t: (lambda: of._fold_runs(buf, d, fold_runs, None, 0, rows, 0, order=order,
                                             long_runs=long_at[t], long_run=t))
    case["ms"] = graph_ms(torch, [launch(of.FOLD_LONG_RUN)], reps=4)
    case["long_run_ms"] = {t: graph_ms(torch, [launch(t)], reps=4) for t in (16, 256, 1024, 1 << 40)}
    case["eager_ms"] = time_ms(torch, launch(of.FOLD_LONG_RUN))
    # the plain version's body, ``index_select`` + ``index_add_`` (its check
    # of the order's range reads the device, which a graph capture refuses)
    case["plain_ms"] = graph_ms(torch, [lambda: buf.index_add_(0, fold_rows,
                                                               d.index_select(0, order))], reps=4)
    case["library_ms"] = graph_ms(torch, [lambda: buf.index_add_(0, fold_rows, gathered)], reps=4)
    moved = nbytes(gathered, order, fold_runs) + 2 * 4 * rows * rank
    case["bound_ms"] = 1e3 * moved / HBM_BYTES_PER_S
    case["bound_by"] = "bytes"
    return case


def exact_sparse_split(torch, coo, factors) -> list:
    """The ``exact`` backend's sparse MTTKRP (``mttkrp_sparse`` on the COO)
    on every mode: the call's time (CUDA events; the COO's sort is kept
    after the first call) and its one chain-route launch's alone on the same
    operands, the rest (the values' gather, the output's zeros, the host)
    the difference. CUDA events only: no profiler window."""
    from repro_torch.core.mttkrp import _sorted_stream, mttkrp_sparse
    from repro_torch.kernels.ordered_fold import ordered_chain_fold

    fs = tuple(factors)
    split = []
    for m in range(len(coo.shape)):
        rows = coo.shape[m]
        call_ms = time_ms(torch, lambda: mttkrp_sparse(coo.indices, coo.values, fs, m, rows),
                          warmup=1, iters=3, reps=1)
        perm, coords, runs, longest, *_ = _sorted_stream(coo.indices, m, rows)
        vals = coo.values[perm]
        out = torch.zeros((rows, fs[0].shape[1]), device="cuda")
        chain_ms = time_ms(torch, lambda: ordered_chain_fold(
            out, coords, vals, fs, m, runs, longest_run=longest), warmup=1, iters=3, reps=1)
        split.append({"mode": m, "longest_run": longest, "call_ms": call_ms,
                      "chain_ms": chain_ms, "rest_ms": call_ms - chain_ms})
    return split


def cold_copies(torch, t, total_bytes: float = 128e6, most: int = 64) -> list:
    """``t`` and copies of it, together past the 50 MB L2."""
    n = max(1, min(most, math.ceil(total_bytes / nbytes(t))))
    return [t] + [t.clone() for _ in range(n - 1)]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- kernel B


def matmul_case(torch, m, k, n, seed, adc_bits=16, timed=False):
    """Kernel 2 on the route ``psram_matmul`` takes at one shape, against its
    plain version (bit-equal); on the wgmma route also against the tile
    route and a second launch (bit-equal); on the tile route the K split it
    took (``split``) and every split of 1 to 8 bit-equal. With ``timed``:
    the route's time (the wgmma route in turns with the tile route: wgmma,
    tile, tile, wgmma), the plain version's, the bound and the library's
    (``torch._int_mm`` + the ADC epilogue, for more than 16 rows), all by
    CUDA events over back-to-back eager calls; on the tile route also the
    route's and the library's device time in a CUDA graph (``graph_ms``,
    ``library_graph_ms``) and the route's at every split (``split_ms``)."""
    from repro_torch.core.quantization import QMAX, adc_transfer
    from repro_torch.kernels.psram_matmul import (_launch, _tile_split, psram_matmul,
                                                  psram_matmul_torch)

    qx, qw, sx, sw = matmul_codes(torch, m, k, n, seed)
    before = dict(psram_matmul.routes)
    got = psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits)
    torch.cuda.synchronize()
    route = next(r for r, c in psram_matmul.routes.items() if c != before[r])
    want = psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits)
    diff = (got - want).abs()
    call = lambda r: (lambda: _launch(qx, qw, sx, sw, adc_bits=adc_bits, route=r))
    case = {
        "shape": [m, k, n], "adc_bits": adc_bits, "route": route,
        "max_abs_err": float(diff.max()),
        "share_differing": float((got != want).float().mean()),
        "bit_equal": bool(torch.equal(got, want)),
        "deterministic": bool(torch.equal(call(route)(), got)),
    }
    del want, diff
    if route == "wgmma":
        case["bit_equal_to_tile"] = bool(torch.equal(call("tile")(), got))
    if route == "tile":                   # the K split it took, and every other split's bits
        case["split"] = _tile_split(m, k, n, torch.cuda.get_device_properties(0)
                                    .multi_processor_count)
        split_call = lambda c: (lambda: _launch(qx, qw, sx, sw, adc_bits=adc_bits, route="tile",
                                                cluster=c))
        case["every_split_equal"] = all(torch.equal(split_call(c)(), got) for c in (1, 2, 4, 8))
    if not (case["bit_equal"] and case["deterministic"] and case.get("bit_equal_to_tile", True)
            and case.get("every_split_equal", True)):
        raise AssertionError(f"psram_matmul differs from its plain version: {case}")
    if timed:
        def library():
            acc = torch._int_mm(qx, qw)
            full_scale = float(QMAX) * float(QMAX) * k
            return adc_transfer(acc, 2 ** adc_bits, full_scale) * (sx * sw)

        if route == "wgmma":
            a1, t1 = time_ms(torch, call("wgmma")), time_ms(torch, call("tile"))
            t2, a2 = time_ms(torch, call("tile")), time_ms(torch, call("wgmma"))
            case.update({"ms": (a1 + a2) / 2, "ms_runs": [a1, a2], "tile_ms": (t1 + t2) / 2,
                         "tile_ms_runs": [t1, t2]})
        else:
            case["ms"] = time_ms(torch, call(route))
        if route == "tile":   # also device times: an eager call of this size is host-paced
            case["graph_ms"] = graph_ms(torch, [call(route)], reps=4)
            case["split_ms"] = {c: graph_ms(torch, [split_call(c)], reps=4) for c in (1, 2, 4, 8)}
        case["plain_ms"] = time_ms(
            torch, lambda: psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits), iters=3, reps=2)
        if m > 16:                        # torch._int_mm takes more than 16 rows only
            case["library_equal"] = bool(torch.equal(library(), got))
            case["library_ms"] = time_ms(torch, library)
            if route == "tile":
                case["library_graph_ms"] = graph_ms(torch, [library], reps=4)
        else:
            case["library_equal"] = case["library_ms"] = None
        bytes_ms = 1e3 * (nbytes(qx, qw, sx, sw) + 4 * m * n) / HBM_BYTES_PER_S
        ops_ms = 1e3 * (2.0 * m * k * n) / INT8_OPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        case["tops"] = 2.0 * m * k * n / case["ms"] / 1e9
    return case


def epilogue_case(torch, m, k, n, seed):
    """The wgmma route at one 128-deep stage: its time is the ring's fill,
    one stage of products and the epilogue (the ADC on 128 accumulators a
    consumer thread and the f32 store of a 256 x 128 tile a CTA), beside the
    least time its f32 output takes to write."""
    from repro_torch.kernels.psram_matmul import _launch, psram_matmul_torch

    qx, qw, sx, sw = matmul_codes(torch, m, k, n, seed)
    got = _launch(qx, qw, sx, sw, route="wgmma")
    case = {"shape": [m, k, n], "bit_equal": bool(torch.equal(got, psram_matmul_torch(qx, qw, sx, sw)))}
    if not case["bit_equal"]:
        raise AssertionError(f"psram_matmul's wgmma route differs from its plain version: {case}")
    case["ms"] = time_ms(torch, lambda: _launch(qx, qw, sx, sw, route="wgmma"))
    case["store_bound_ms"] = 1e3 * 4.0 * m * n / HBM_BYTES_PER_S
    return case


def matmul_codes(torch, m, k, n, seed):
    from repro_torch.core.quantization import quantize_symmetric

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda")
    qx, sx = quantize_symmetric(x, axis=-1)
    qw, sw = quantize_symmetric(w, axis=0)
    return qx, qw, sx, sw


def decode_case(torch, m, k, n, seed, timed=False, tuning=False):
    """Kernel 2's decode route against its plain version and the tile route
    (both bit-equal) at one shape, every cluster size included; with
    ``timed`` both routes timed in turns (decode, tile, tile, decode), the
    bound, and the library: ``torch._int_mm`` on qx zero-padded to 32 rows
    (it takes more than 16 only) plus the ADC epilogue; with ``tuning``
    also every cluster size timed (the evidence for the library's choice)."""
    from repro_torch.core.quantization import QMAX, adc_transfer
    from repro_torch.kernels.psram_matmul import _decode_cluster, _launch, psram_matmul_torch

    qx, qw, sx, sw = matmul_codes(torch, m, k, n, seed)
    got = _launch(qx, qw, sx, sw, route="decode")
    torch.cuda.synchronize()
    want = psram_matmul_torch(qx, qw, sx, sw)
    tile = _launch(qx, qw, sx, sw, route="tile")
    case = {
        "shape": [m, k, n],
        "cluster": _decode_cluster(k, n, torch.cuda.get_device_properties(0).multi_processor_count),
        "max_abs_err": float((got - want).abs().max()),
        "bit_equal": bool(torch.equal(got, want)),
        "bit_equal_to_tile": bool(torch.equal(got, tile)),
        "deterministic": bool(torch.equal(_launch(qx, qw, sx, sw, route="decode"), got)),
        "every_cluster_equal": all(
            torch.equal(_launch(qx, qw, sx, sw, route="decode", cluster=c), got)
            for c in (1, 2, 4, 8)),
    }
    if not (case["bit_equal"] and case["bit_equal_to_tile"] and case["deterministic"]
            and case["every_cluster_equal"]):
        raise AssertionError(f"psram_matmul's decode route differs from its plain version: {case}")
    if timed:
        # device time of cold calls (CUDA graph over weight copies past the
        # L2), the routes in turns: decode, tile, tile, decode
        ws = cold_copies(torch, qw)
        runs = {route: [lambda w=w, r=route: _launch(qx, w, sx, sw, route=r) for w in ws]
                for route in ("decode", "tile")}
        d1, t1 = graph_ms(torch, runs["decode"]), graph_ms(torch, runs["tile"])
        t2, d2 = graph_ms(torch, runs["tile"]), graph_ms(torch, runs["decode"])
        if tuning:
            case["cluster_ms"] = {c: graph_ms(torch, [
                lambda w=w, c=c: _launch(qx, w, sx, sw, route="decode", cluster=c)
                for w in ws]) for c in (1, 2, 4, 8)}
        # and one call at a time from the host, as the eager decode step makes it
        case["call_ms"] = time_ms(torch, lambda: _launch(qx, qw, sx, sw, route="decode"))
        case["weight_copies"] = len(ws)
        pad = max(0, 32 - m)
        qx_pad = torch.nn.functional.pad(qx, (0, 0, 0, pad)).contiguous()

        def library_on(w):
            acc = torch._int_mm(qx_pad, w)[:m]
            full_scale = float(QMAX) * float(QMAX) * k
            return adc_transfer(acc, 2 ** 16, full_scale) * (sx * sw)

        library = lambda: library_on(qw)

        case.update({
            "ms": (d1 + d2) / 2, "tile_ms": (t1 + t2) / 2, "ms_runs": [d1, d2],
            "tile_ms_runs": [t1, t2],
            "plain_ms": time_ms(torch, lambda: psram_matmul_torch(qx, qw, sx, sw),
                                iters=3, reps=2),
            "library": f"torch._int_mm on qx zero-padded from {m} to {m + pad} rows + ADC",
            "library_equal": bool(torch.equal(library(), want)),
            "library_ms": graph_ms(torch, [lambda w=w: library_on(w) for w in ws]),
        })
        bytes_ms = 1e3 * (nbytes(qx, qw, sx, sw) + 4 * m * n) / HBM_BYTES_PER_S
        ops_ms = 1e3 * (2.0 * m * k * n) / INT8_OPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        if case["ms"] >= case["tile_ms"]:
            raise AssertionError(f"the decode route is not faster than the tile route: {case}")
    return case


def crossover_sweep(torch, ms):
    """Both routes of kernel 2 timed in one process over the rows ``ms`` at
    two decode widths (the decode route up to its 16 rows), device time of
    cold calls (:func:`graph_ms`): where the decode route stops winning is
    ``M_DECODE``'s evidence. Fails if the tile route is faster at any
    ``M <= M_DECODE`` (the rows routed to the decode kernel)."""
    from repro_torch.kernels.psram_matmul import M_DECODE, _launch

    rows = []
    for k, n in CROSSOVER_KN:
        qw = None
        for m in ms:
            qx, qw_m, sx, sw = matmul_codes(torch, m, k, n, seed=m + n)
            if qw is None:
                qw = qw_m
                ws = cold_copies(torch, qw)
            call = lambda w, r: _launch(qx, w, sx, sw, route=r)
            row = {"shape": [m, k, n],
                   "tile_ms": graph_ms(torch, [lambda w=w: call(w, "tile") for w in ws])}
            row["decode_ms"] = graph_ms(torch, [lambda w=w: call(w, "decode") for w in ws]) \
                if m <= 16 else None
            rows.append(row)
            if m <= M_DECODE and row["decode_ms"] >= row["tile_ms"]:
                raise AssertionError(f"the tile route beats the decode route at M = {m} "
                                     f"<= M_DECODE: {row}")
    return rows


def small_decode_cases(torch):
    """Ragged decode rows: one row, odd K, N under one column block, M
    across two n8 tiles, a K that is not a multiple of 32."""
    return [decode_case(torch, m, k, n, seed=30 + i) for i, (m, k, n) in enumerate([
        (1, 7, 3), (3, 1043, 131), (5, 33, 7), (9, 4096, 1024), (13, 100, 1000),
        (16, 2048, 8), (16, 4100, 72)])]


# ---------------------------------------------------------------- kernel A


def stream_case(torch, csf, factors, cfg, adc_bits, exec_blocks=None,
                timed=False, cpu_bit_check=False):
    """Kernel A against its plain version on one mode-rooted CSF.

    Pass: every output element within the sum, over the row's segments, of
    one ADC code of the segment's chunk (``2*full_scale/2^bits``), plus 1e-6
    of the summed full scales (float reassociation of the plain version's
    unordered ``index_add_`` on the card); the pre-ADC per-chunk max within
    1e-5 relative (f32 sums of up to ``rows`` terms in two orders). With
    ``cpu_bit_check`` the kernel is also held BIT-EQUAL to the plain version
    run on the CPU, whose ``index_add_`` adds in stream order like the kernel.
    """
    from repro_torch.kernels import stream_mttkrp as sm
    from repro_torch.kernels.autotune import stream_params
    from repro_torch.kernels.stream_mttkrp import (
        SegmentPlan, quantize_stream_factors, stream_mttkrp_fused,
        stream_mttkrp_fused_torch)
    from repro_torch.sparse.stream import stream_layout

    mode = csf.mode_order[0]
    out_rows = csf.shape[mode]
    if exec_blocks is None:
        exec_blocks = stream_params(csf, factors, cfg)["exec_blocks"]
    ip, vp, lp, sp, n_seg = stream_layout(csf, cfg.rows, exec_blocks)
    qs, ss = quantize_stream_factors(factors, mode)
    plan = SegmentPlan.build(lp, sp, n_seg, out_rows)
    args = (ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows)
    counts = stream_mttkrp_fused.routes
    before = dict(counts)

    got, got_max = stream_mttkrp_fused(*args, plan=plan, return_chunk_max=True)
    torch.cuda.synchronize()
    route = next(r for r in counts if counts[r] > before[r])
    others = [d for d in range(len(qs)) if d != mode]
    aligned = all(qs[d].data_ptr() % 16 == 0 for d in others)
    # the routes that can take the layout
    smem = sm._chunk_smem(got.shape[1], len(qs), plan.chunk_segs)
    routes = [r for r in sm.ROUTES
              if r != "chunk" or sm._chunk_takes(got.shape[1], smem, aligned)]
    on_route = lambda r: sm._launch(*args, plan=plan, return_chunk_max=True, route=r)
    want, want_max = stream_mttkrp_fused_torch(*args, return_chunk_max=True)

    # per-row tolerance from the plan: one code per segment of the row
    fs = want_max.clamp_min(1e-30).double()
    lsb = (2.0 * fs / 2 ** adc_bits) if adc_bits else torch.zeros_like(fs)
    per_seg = lsb[plan.seg_chunk.long()] + 1e-6 * fs[plan.seg_chunk.long()]
    csum = torch.cat([per_seg.new_zeros(1), per_seg.cumsum(0)])
    row_tol = csum[plan.row_ptr[1:].long()] - csum[plan.row_ptr[:-1].long()]
    diff = (got - want).abs().double()
    excess = float((diff - row_tol[:, None]).max())
    rel_max = float(((got_max - want_max).abs() / want_max.clamp_min(1e-30)).max())
    nnz_pad = vp.numel()
    case = {
        "mode": mode, "shape": list(csf.shape), "nnz": csf.nnz,
        "rank": int(got.shape[1]), "rows": cfg.rows, "exec_blocks": exec_blocks,
        "chunks": int(ip.shape[0]), "n_seg": n_seg, "segments": plan.total,
        "chunk_segs": plan.chunk_segs, "route": route,
        "adc_bits": adc_bits,
        "max_abs_err": float(diff.max()),
        "max_err_in_codes": float((diff.max(dim=1).values / row_tol.clamp_min(1e-300)).max())
        if adc_bits else None,
        "share_differing": float((got != want).float().mean()),
        "chunk_max_rel_diff": rel_max,
        "chunk_max_bit_equal": bool(torch.equal(got_max, want_max)),
        "finite": bool(torch.isfinite(got).all()),
    }
    if not case["finite"] or excess > 0 or rel_max > 1e-5:
        raise AssertionError(f"stream_mttkrp_fused disagrees with its plain version: {case}")
    if cpu_bit_check:
        cpu = lambda t: t.cpu()
        want_cpu, max_cpu = stream_mttkrp_fused_torch(
            cpu(ip), cpu(vp), cpu(lp), cpu(sp), tuple(map(cpu, qs)),
            tuple(map(cpu, ss)), mode, n_seg, adc_bits, out_rows,
            return_chunk_max=True)
        case["bit_equal_to_ordered_plain"] = bool(torch.equal(got.cpu(), want_cpu))
        case["chunk_max_bit_equal_to_ordered_plain"] = bool(torch.equal(got_max.cpu(), max_cpu))
        # every route that can take the layout, each bit-equal to the CPU
        case["routes_bit_equal"] = {}
        for r in routes:
            out_r, max_r = on_route(r)
            case["routes_bit_equal"][r] = bool(torch.equal(out_r.cpu(), want_cpu)
                                               and torch.equal(max_r.cpu(), max_cpu))
        if not (case["bit_equal_to_ordered_plain"]
                and case["chunk_max_bit_equal_to_ordered_plain"]
                and all(case["routes_bit_equal"].values())):
            raise AssertionError(
                f"stream_mttkrp_fused is not bit-equal to the ordered plain version: {case}")
    if timed:
        # each route that can take the layout: the same bits, its time and
        # its device time by operation; the call's are its route's
        case["routes"] = {}
        for r in routes:
            out_r, max_r = on_route(r)
            if not (torch.equal(out_r, got) and torch.equal(max_r, got_max)):
                raise AssertionError(f"kernel 1's {r} route disagrees with the {route} route: "
                                     f"{case}")
            launch = lambda r=r: on_route(r)
            ms = time_ms(torch, launch)
            case["routes"][r] = {"ms": ms, "passes_ms": pass_split(torch, launch, ms)}
        case["ms"] = case["routes"][route]["ms"]
        case["passes_ms"] = case["routes"][route]["passes_ms"]
        case["plain_ms"] = time_ms(torch, lambda: stream_mttkrp_fused_torch(*args), iters=3, reps=1)
        moved = nbytes(ip, vp, lp, sp, *[qs[d] for d in others],
                       *[ss[d] for d in others]) + 4 * got.numel()
        bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
        # per nonzero and column: (len(others)-1) Hadamard multiplies, one
        # scale multiply, one add; per segment and column the ADC (~6)
        flops = nnz_pad * got.shape[1] * (len(others) + 1) + 6.0 * plan.total * got.shape[1]
        ops_ms = 1e3 * flops / F32_FLOPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return case


def small_stream_cases(torch):
    """Ragged/small streams: ragged last block, an empty row, a fiber that
    spans chunks, 4 modes, rank not a multiple of 32, ADC off — at ranks the
    three_pass route alone takes (6, 40) and at ranks both routes take (32,
    16), each held bit-equal to the CPU on every route that takes it."""
    from repro_torch.core.psram import PsramConfig
    from repro_torch.sparse import csf_for_mode, powerlaw_coo

    cases = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    # rows=16, 4 blocks per chunk: the Zipf head row owns far more than the
    # 64 nonzeros of a chunk; 40 rows x ~900 nonzeros leaves tail rows empty
    coo = powerlaw_coo(5, (40, 24, 18), nnz=900, rank=4, alpha=1.6, device="cuda")
    cfg = PsramConfig(rows=16)
    for rank in (6, 32):
        fs = tuple(torch.randn((s, rank), generator=gen, device="cuda") for s in coo.shape)
        for mode in range(3):
            csf = csf_for_mode(coo, mode)
            if mode == 0:
                lengths = csf.fiber_lengths()
                assert csf.nnz % 16 != 0, "fixture lost its ragged last block"
                assert len(lengths) < 40, "fixture lost its empty rows"
                assert lengths.max() > 64, "fixture lost its chunk-spanning fiber"
            for adc_bits in (16, 0):
                cases.append(stream_case(torch, csf, fs, cfg, adc_bits, exec_blocks=4,
                                         cpu_bit_check=True))
    coo4 = powerlaw_coo(6, (50, 12, 9, 7), nnz=20000, rank=3, alpha=1.1, device="cuda")
    for rank in (40, 16):
        fs4 = tuple(torch.randn((s, rank), generator=gen, device="cuda") for s in coo4.shape)
        for mode in (0, 3):
            cases.append(stream_case(torch, csf_for_mode(coo4, mode), fs4, PsramConfig(),
                                     16, cpu_bit_check=True))
    return cases


# ------------------------------------------------- kernels 3 and 4 (dense)


def dense_case(torch, x0, b, c, timed=False):
    """Kernel 3 against its plain version: allclose at rtol 2e-4 and 2e-4 of
    the largest entry (the reference's own tolerance for its kernel)."""
    from repro_torch.core.mttkrp import khatri_rao
    from repro_torch.kernels.mttkrp import mttkrp_fused, mttkrp_fused_torch

    i, jk = x0.shape
    r = b.shape[1]
    got = mttkrp_fused(x0, b, c)
    torch.cuda.synchronize()
    want = mttkrp_fused_torch(x0, b, c)
    diff = (got - want).abs()
    top = float(want.abs().max())
    big = want.abs() >= 1e-3 * top
    case = {
        "shape": [i, b.shape[0], c.shape[0], r],
        "max_abs_err": float(diff.max()),
        "max_err_over_max": float(diff.max()) / max(top, 1e-30),
        "max_rel_err": float((diff[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0,
        "finite": bool(torch.isfinite(got).all()),
        "deterministic": bool(torch.equal(mttkrp_fused(x0, b, c), got)),
    }
    if not (case["finite"] and case["deterministic"]
            and torch.allclose(got, want, rtol=2e-4, atol=2e-4 * top)):
        raise AssertionError(f"mttkrp_fused disagrees with its plain version: {case}")
    if timed:
        case["ms"] = time_ms(torch, lambda: mttkrp_fused(x0, b, c))
        case["plain_ms"] = time_ms(torch, lambda: mttkrp_fused_torch(x0, b, c), iters=3, reps=1)
        case["library_ms"] = time_ms(torch, lambda: x0 @ khatri_rao([b, c]))
        bytes_ms = 1e3 * (nbytes(x0, b, c) + 4 * i * r) / HBM_BYTES_PER_S
        ops_ms = 1e3 * (2.0 * i * jk * r + jk * r) / F32_FLOPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return case


def psram_case(torch, q, adc_bits=16, timed=False):
    """Kernel 4 against its plain version: within two ADC codes of each
    bi-row tile's full scale plus rtol 2e-4 (the reference's own tolerance
    for its kernel against its XLA twin)."""
    from repro_torch.core.quantization import adc_transfer
    from repro_torch.kernels.mttkrp import mttkrp_psram_fused, mttkrp_psram_torch

    qx, sx, qb, sb, qc, sc = q
    i, jk = qx.shape
    r = qb.shape[1]
    bi = min(128, i)
    got = mttkrp_psram_fused(*q, adc_bits=adc_bits)
    torch.cuda.synchronize()
    want = mttkrp_psram_torch(*q, adc_bits=adc_bits)
    fs = want.abs().reshape(i // bi, -1).amax(dim=1).clamp_min(1e-30)
    lsb = (2.0 * fs / 2 ** adc_bits).repeat_interleave(bi)[:, None]
    diff = (got - want).abs()
    case = {
        "shape": [i, qb.shape[0], qc.shape[0], r], "adc_bits": adc_bits, "bi": bi,
        "max_abs_err": float(diff.max()),
        "max_err_in_codes": float((diff / lsb).max()),
        "elements_a_code_apart": int((diff >= 0.5 * lsb).sum()),
        **code_flip_analysis(torch, got, want, fs, bi, lsb),
        "elements": got.numel(),
        "finite": bool(torch.isfinite(got).all()),
        "deterministic": bool(torch.equal(mttkrp_psram_fused(*q, adc_bits=adc_bits), got)),
    }
    if not (case["finite"] and case["deterministic"]
            and bool((diff <= 2 * lsb + 2e-4 * want.abs()).all())):
        raise AssertionError(f"mttkrp_psram_fused disagrees with its plain version: {case}")
    if timed:
        def library():
            kr = (qb.float()[:, None, :] * qc.float()[None]) * (sb[:, None, :] * sc[None])
            out = (qx.float() * sx) @ kr.reshape(jk, r)
            tiles = out.reshape(i // bi, bi, r)
            full = tiles.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
            return adc_transfer(tiles, 2 ** adc_bits, full).reshape(i, r)

        case["ms"] = time_ms(torch, lambda: mttkrp_psram_fused(*q, adc_bits=adc_bits))
        case["plain_ms"] = time_ms(
            torch, lambda: mttkrp_psram_torch(*q, adc_bits=adc_bits), iters=3, reps=1)
        case["library_ms"] = time_ms(torch, library, iters=3, reps=1)
        bytes_ms = 1e3 * (nbytes(*q) + 4 * i * r) / HBM_BYTES_PER_S
        # per entry of X_(0): its scale multiply and R multiply-adds; per KR
        # entry 3 multiplies; per output the ADC (~6)
        ops_ms = 1e3 * (2.0 * i * jk * r + i * jk + 3.0 * jk * r + 6.0 * i * r) \
            / F32_FLOPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return case


def strided_case(torch, view, q, adc_bits=16, timed=False):
    """Kernel 4 reading the f32 tensor in place (``mttkrp_psram_strided`` on
    the permuted view): its row scales and its converter's codes equal to
    ``quantize_symmetric``'s on the unfolding (``q``, those operands), its
    output bit-equal to the codes front end on ``q`` (where both walks cut
    the same stages), at ``adc_bits`` and at 24 bits, where one code of the
    ring's own staging shows, and repeatable, and within two ADC codes of each
    bi-row tile's full scale plus rtol 2e-4 of the plain version. With
    ``timed``: the call, its row-max pass and its ring (pass 1 + ADC) alone,
    the codes front end's ring and the partials kernel on ``q``, the plain
    version; bounds by bytes (the tensor read once) and operations."""
    from repro_torch.kernels import mttkrp as dm

    qx, sx, qb, sb, qc, sc = q
    rw, r = qx.shape[0], qb.shape[1]
    a, _, b = dm._layout_of(view)
    front = "cols" if b == 1 else "rows"
    scales = dm.drive_scales(view)
    codes_equal = bool(torch.equal(dm.drive_codes(view, scales), qx))
    got = dm.mttkrp_psram_strided(view, qb, sb, qc, sc, adc_bits=adc_bits)
    torch.cuda.synchronize()
    same_stages = a == 1 or b == 1 or b % 32 == 0
    codes_out = dm.mttkrp_psram_fused(*q, adc_bits=adc_bits)
    want = dm.mttkrp_psram_strided_torch(view, qb, sb, qc, sc, adc_bits=adc_bits)
    bi = min(128, rw)
    fs = want.abs().reshape(rw // bi, -1).amax(dim=1).clamp_min(1e-30)
    lsb = (2.0 * fs / 2 ** adc_bits).repeat_interleave(bi)[:, None]
    diff = (got - want).abs()
    case = {
        "shape": list(view.shape) + [r], "layout": [a, rw, b], "front": front,
        "adc_bits": adc_bits,
        "scales_equal": bool(torch.equal(scales, sx)), "codes_equal": codes_equal,
        "same_stages": same_stages,
        "bit_equal_to_codes_front": bool(torch.equal(got, codes_out)),
        # at 24 bits one code of the ring's own staged tile moves the output
        "bit_equal_to_codes_front_24": bool(torch.equal(
            dm.mttkrp_psram_strided(view, qb, sb, qc, sc, adc_bits=24),
            dm.mttkrp_psram_fused(*q, adc_bits=24))),
        "repeatable": bool(torch.equal(
            dm.mttkrp_psram_strided(view, qb, sb, qc, sc, adc_bits=adc_bits), got)),
        "max_abs_err": float(diff.max()),
        "max_err_in_codes": float((diff / lsb).max()),
        "finite": bool(torch.isfinite(got).all()),
    }
    if not (case["scales_equal"] and codes_equal and case["repeatable"] and case["finite"]
            and ((case["bit_equal_to_codes_front"] and case["bit_equal_to_codes_front_24"])
                 or not same_stages)
            and bool((diff <= 2 * lsb + 2e-4 * want.abs()).all())):
        raise AssertionError(f"mttkrp_psram_strided disagrees: {case}")
    if timed:
        i_jk = qx.numel()
        case["ms"] = time_ms(torch, lambda: dm.mttkrp_psram_strided(
            view, qb, sb, qc, sc, adc_bits=adc_bits))
        case["rowmax_ms"] = time_ms(torch, lambda: dm.drive_scales(view))
        case["ring_ms"] = time_ms(torch, lambda: dm._ring(
            front, view, scales, qb, sb, qc, sc, a, rw, b, bi, adc_bits))
        case["codes_partials_ms"] = time_ms(torch, lambda: dm._launch_codes(
            *q, bi=bi, adc_bits=adc_bits, route="partials"))
        case["plain_ms"] = time_ms(torch, lambda: dm.mttkrp_psram_strided_torch(
            view, qb, sb, qc, sc, adc_bits=adc_bits), iters=3, reps=1)
        case["library_ms"] = None
        x_bytes = 4 * i_jk
        bytes_ms = 1e3 * (x_bytes + nbytes(qb, sb, qc, sc) + 4 * rw * r) / HBM_BYTES_PER_S
        # per entry of the tensor: 5 for its row max and quantization (max,
        # divide, round, clamp, the dequantizing multiply) and R
        # multiply-adds; per KR entry 3 multiplies; per output the ADC (~6)
        jk = i_jk // rw
        ops_ms = 1e3 * (2.0 * i_jk * r + 5.0 * i_jk + 3.0 * jk * r + 6.0 * rw * r) \
            / F32_FLOPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        case["ops_bound_ms"] = ops_ms
        case["rowmax_bound_ms"] = 1e3 * (x_bytes + 4 * rw) / HBM_BYTES_PER_S
    return case


def small_strided_cases(torch):
    """The strided route at ragged shapes: I = 384 (not a multiple of the
    ring's 256 rows), mode 1's B = 36 (its stages stop at each a: within
    the codes, not bit-equal to the codes front end), ADC at 8 bits."""
    from repro_torch.kernels.mttkrp import quantize_mttkrp_operands

    gen = torch.Generator(device="cuda").manual_seed(13)
    shape = (384, 20, 36)
    x = torch.randn(shape, generator=gen, device="cuda")
    fs = [torch.randn((n, 16), generator=gen, device="cuda") for n in shape]
    cases = []
    for mode in range(3):
        others = [d for d in range(3) if d != mode]
        view = x.permute([mode] + others)
        q = quantize_mttkrp_operands(view.reshape(shape[mode], -1).contiguous(),
                                     fs[others[0]], fs[others[1]])
        cases += [strided_case(torch, view, q, adc_bits=bits) for bits in (16, 8)]
    return cases


def code_flip_analysis(torch, got, want, fs, bi, lsb) -> dict:
    """Why kernel 4 strays past one ADC code: per ``bi``-row tile, the
    kernel's full scale relative to the plain version's, estimated as the
    median of ``got / want - 1`` over the tile's large elements (most keep
    their code, so their ratio is exactly that of the two LSBs); then what is
    left of each element once that scale is taken out, in codes. A whole
    number of codes (at most one) and a small residual confirm: one code
    flipped at a rounding boundary, every code's LSB moved by the tile's
    full scale (f32 reassociation of the tile's max)."""
    i = got.shape[0]
    g, w = got.reshape(i // bi, -1), want.reshape(i // bi, -1)
    big = w.abs() >= 0.25 * fs[:, None]
    ratio = torch.where(big, g / w.where(big, torch.ones_like(w)) - 1, torch.nan)
    delta = ratio.nanmedian(dim=1).values.nan_to_num(0.0)              # (tiles,)
    flips = ((g - w * (1 + delta[:, None])) / lsb.reshape(i // bi, bi)[:, :1]).double()
    k = flips.round()
    return {"full_scale_rel_diff_max": float(delta.abs().max()),
            "codes_flipped_max": int(k.abs().max()),
            "residual_in_codes": float((flips - k).abs().max())}


def small_dense_cases(torch):
    """Ragged where legal (I % bi == 0 and K % bk == 0 with bi = min(128, I),
    bk = min(128, K)): element-wise loads (J*K odd), rank over one column
    tile, rank under 8, ADC at 8 bits."""
    from repro_torch.kernels.mttkrp import quantize_mttkrp_operands

    gen = torch.Generator(device="cuda").manual_seed(12)
    exact, psram = [], []
    for i, j, k, r in [(96, 5, 40, 7), (32, 3, 11, 40), (128, 7, 36, 16), (384, 2, 256, 33)]:
        x0 = torch.randn((i, j * k), generator=gen, device="cuda")
        b = torch.rand((j, r), generator=gen, device="cuda")
        c = torch.randn((k, r), generator=gen, device="cuda")
        exact.append(dense_case(torch, x0, b, c))
        q = quantize_mttkrp_operands(x0, b, c)
        psram += [psram_case(torch, q, adc_bits=bits) for bits in (16, 8)]
    return exact, psram


# ---------------------------------------------------------- kernel 5


def segment_case(torch, data, ids, n_seg, timed=False, cpu_bit_check=False):
    """Kernel 5 against its plain version on the card, whose atomic
    index_add_ adds in no fixed order: every element within the worst case
    of two recursive f32 sums of its slot's rows, ``2 (bn - 1) 2^-24`` times
    the sum of their magnitudes; the error against 1e-6 of the largest
    partial is reported. With ``cpu_bit_check`` the kernel is held BIT-EQUAL
    to the plain version run on the CPU, whose index_add_ adds the rows in
    order like the kernel."""
    from repro_torch.kernels.segment_sum import blocked_segment_sum, blocked_segment_sum_torch

    b, bn, r = data.shape
    got = blocked_segment_sum(data, ids, n_seg)
    torch.cuda.synchronize()
    want = blocked_segment_sum_torch(data, ids, n_seg)
    diff = (got - want).abs()
    top = float(want.abs().max())
    mag = blocked_segment_sum_torch(data.abs(), ids, n_seg)
    case = {
        "blocks": b, "rows": bn, "rank": r, "n_seg": n_seg,
        "max_abs_err": float(diff.max()),
        "max_err_over_max": float(diff.max()) / max(top, 1e-30),
        "within_1e-6_of_max": float(diff.max()) <= 1e-6 * top,
        "max_err_over_magnitude": float((diff / mag.clamp_min(1e-30)).max()),
        "share_differing": float((got != want).float().mean()),
        "finite": bool(torch.isfinite(got).all()),
    }
    del mag
    if not case["finite"] or case["max_err_over_magnitude"] > 2 * (bn - 1) * 2.0 ** -24:
        raise AssertionError(f"blocked_segment_sum disagrees with its plain version: {case}")
    if cpu_bit_check:
        case["bit_equal_to_ordered_plain"] = bool(torch.equal(
            got.cpu(), blocked_segment_sum_torch(data.cpu(), ids.cpu(), n_seg)))
        if not case["bit_equal_to_ordered_plain"]:
            raise AssertionError(
                f"blocked_segment_sum is not bit-equal to the ordered plain version: {case}")
    if timed:
        slot = (torch.arange(b, device="cuda").view(b, 1) * n_seg + ids).reshape(-1)
        rows = data.reshape(b * bn, r)
        lib_out = torch.zeros((b * n_seg, r), device="cuda")

        def library():
            lib_out.zero_()
            return lib_out.index_add_(0, slot, rows)

        case["ms"] = time_ms(torch, lambda: blocked_segment_sum(data, ids, n_seg))
        case["plain_ms"] = time_ms(
            torch, lambda: blocked_segment_sum_torch(data, ids, n_seg), iters=3, reps=1)
        case["library_ms"] = time_ms(torch, library, iters=3, reps=1)
        moved = nbytes(data, ids) + 4 * b * n_seg * r
        bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
        ops_ms = 1e3 * (b * bn * r) / F32_FLOPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return case


def chain_segment_case(torch, csf, factors, cfg, chain, cpu_bit_check=False):
    """Kernel 5's chain route (the chain formed in the kernel) on one mode's
    stream at full size: BIT-EQUAL to the rows route over the padded chain
    ``chain`` (the composition the ``compiled=False`` path ran before it),
    repeatable, and with ``cpu_bit_check`` bit-equal to its plain version on
    the CPU; timed by CUDA events beside the composition (the eager chain
    and the rows route), its plain version on the card and its bound: the
    coordinates, values and ids read once, the non-target factors once, the
    partials written once (the factor rows it gathers from L2,
    ``l2_gather_bytes``, are a count: no L2 rate is sourced)."""
    from repro_torch.kernels.segment_sum import (
        blocked_chain_segment_sum, blocked_chain_segment_sum_torch, blocked_segment_sum,
        padded_chain)
    from repro_torch.sparse.stream import _chain_stream, _segment_blocks

    mode = csf.mode_order[0]
    local, n_seg = _segment_blocks(csf, cfg.rows)[:2]
    coords, vals, fs = _chain_stream(csf)[0], csf.values, tuple(factors)
    args = (coords, vals, local, fs, mode, n_seg)
    got = blocked_chain_segment_sum(*args)
    rows = blocked_segment_sum(chain, local, n_seg)
    b, _, r = got.shape
    k = len(fs) - 1
    case = {
        "mode": mode, "nnz": csf.nnz, "blocks": b, "rows": cfg.rows, "rank": r,
        "n_seg": n_seg, "max_abs_err": float((got - rows).abs().max()),
        "bit_equal_to_rows_route": bool(torch.equal(got, rows)),
        "repeatable": bool(torch.equal(blocked_chain_segment_sum(*args), got)),
        "finite": bool(torch.isfinite(got).all()),
    }
    del rows
    if cpu_bit_check:
        case["bit_equal_to_cpu_plain"] = bool(torch.equal(
            got.cpu(), blocked_chain_segment_sum_torch(
                coords.cpu(), vals.cpu(), local.cpu(), tuple(f.cpu() for f in fs), mode, n_seg)))
    if not (case["bit_equal_to_rows_route"] and case["repeatable"] and case["finite"]
            and case.get("bit_equal_to_cpu_plain", True)):
        raise AssertionError(f"the chain route disagrees with the rows route's composition, "
                             f"the CPU or itself: {case}")
    case["ms"] = time_ms(torch, lambda: blocked_chain_segment_sum(*args))
    case["composition_ms"] = time_ms(torch, lambda: blocked_segment_sum(
        padded_chain(coords, vals, local, fs, mode), local, n_seg), iters=3, reps=1)
    case["plain_ms"] = time_ms(torch, lambda: blocked_chain_segment_sum_torch(*args),
                               iters=3, reps=1)
    others = [f for d, f in enumerate(fs) if d != mode]
    moved = nbytes(coords, vals, local, *others) + 4 * b * n_seg * r
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * csf.nnz * r * (k + 1) / F32_FLOPS_PER_S
    case["bound_ms"] = max(bytes_ms, ops_ms)
    case["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    case["l2_gather_bytes"] = csf.nnz * k * r * 4
    return case


def small_segment_cases(torch):
    """Unsorted ids, rank over one column tile, more slots than rows, a
    64 KB shared-memory tile; all bit-equal to the CPU plain version."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = []
    for b, bn, r, n_seg, sort in [(9, 100, 40, 17, False), (3, 5, 3, 9, False),
                                  (4, 600, 8, 500, False), (64, 256, 32, 40, True)]:
        data = torch.randn((b, bn, r), generator=gen, device="cuda")
        ids = torch.randint(0, n_seg, (b, bn), generator=gen, device="cuda", dtype=torch.int32)
        if sort:
            ids = ids.sort(dim=1).values.contiguous()
        cases.append(segment_case(torch, data, ids, n_seg, cpu_bit_check=True))
    return cases



# ------------------------------------------- the quantized chain routes


def psram_chain_ops(k: int) -> tuple[int, int]:
    """The f32 operations the quantized chain and its fold cost a nonzero of
    ``k`` non-target modes per rank column, as the function is written (the
    port's ``core.mttkrp.psram_chain``, each quotient one operation), and
    the quotients among them: the first row quantized (|.| and max,
    division, rint, two clamps, two conversions, the scale's product: 9, 1
    quotient); each further mode's running Hadamard and row quantized, their
    integer product through the ADC (quotient, rint, two clamps, its LSB)
    and both scales (22, 3 quotients); CP2's chain quantized and driven by
    the value's code through the ADC (15, 2 quotients); the fold's add (1).
    The per-row scales and maxima are left out. The function's count, not
    an implementation's: the operation bound."""
    return 9 + 22 * (k - 1) + 15 + 1, 1 + 3 * (k - 1) + 2


def psram_chain_instructions(k: int) -> int:
    """The instructions a lane issues a nonzero of ``k`` non-target modes per
    rank column in the kernels' quantized chain (``hopper::psram_chain_pieces``
    and ``psram_div`` in ``csrc/hopper.cuh``), counted from the source, each
    quotient the reciprocal sequence's 5 (``fma(x, rs, 0)`` and two
    corrections of two fmas): the first row (its max 1, code 8 — quotient,
    rint, two clamps — and its value times the scale 1: 10); each further
    mode (both maxima 2, both codes 16, their product 1, the ADC 9 —
    quotient, rint, two clamps, its LSB — and both scales 1: 29); CP2 (the
    max 1, the code 8, the product with the value's code 1, the ADC 9, the
    scales 1: 20); the fold's add (1). The per-row scales, reciprocals and
    shuffles are left out."""
    return 10 + 29 * (k - 1) + 20 + 1


def psram_bounds(nnz: int, rank: int, k: int, moved: int) -> dict:
    """The least time of a quantized chain route: its bytes over HBM's rate
    against its operations (:func:`psram_chain_ops`) over the f32 peak;
    beside it two instruction bounds, one f32 instruction a lane a cycle:
    the kernels' (:func:`psram_chain_instructions`, the source of today)
    and the first draft's (each quotient a true division of
    ``FDIV_INSTRUCTIONS``)."""
    ops, divs = psram_chain_ops(k)
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * nnz * rank * ops / F32_FLOPS_PER_S
    fdiv = nnz * rank * (ops - divs + divs * FDIV_INSTRUCTIONS)
    instr = nnz * rank * psram_chain_instructions(k)
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
            "instruction_bound_ms": 1e3 * instr / F32_INSTRUCTIONS_PER_S,
            "instruction_bound_fdiv_ms": 1e3 * fdiv / F32_INSTRUCTIONS_PER_S,
            "ops_per_nonzero_column": ops, "divisions_per_nonzero_column": divs,
            "instructions_per_nonzero_column": psram_chain_instructions(k)}


def ptxas_of(name: str, entries: dict) -> dict:
    """Registers, spills and stack of kernel instantiations, from the
    ``ptxas -v`` log nvcc left beside library ``name``: ``{label: {...}}``
    for each ``label: substring of the mangled entry name`` in ``entries``
    (the first entry that matches)."""
    from repro_torch.kernels import _build

    log = _build.library_path(name).with_suffix(".log")
    props, entry = {}, None
    for line in log.read_text().splitlines() if log.exists() else ():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m[1]
            props.setdefault(entry, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            props[entry].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            props[entry]["registers"] = int(m[1])
    return {label: next((v for e, v in props.items() if key in e), None)
            for label, key in entries.items()}


def psram_route_case(torch, csf, factors, cfg, adc_bits):
    """Both chain routes' quantized variants (``psram=True``) on one mode's
    stream at full size, as the ``psram-stream`` backend launches them: the
    ordered fold's chain route (the eager path, one launch a call, its runs
    of ``CHAIN_LONG_RUN`` nonzeros or more a cluster each) and kernel 5's
    chain route (the compiled path's partials). Each BIT-EQUAL to its plain
    version's arithmetic on the card — the plain chain (``cp_chain_psram``:
    elementwise IEEE ops, the CPU's bits) folded by the kernels that add in
    order (the fold route over the stream; the rows route over the padded
    chain) — and repeatable; timed by CUDA events beside the exact chain on
    the same route in the same call, the plain version on the card (its
    ``index_add_`` atomic) and the bounds of :func:`psram_bounds`. Where the
    stream has long runs, the launch must have given each a cluster of
    ``CLUSTER`` CTAs (``layout``: which launch took which runs) and the head
    row's launch alone is timed (``head_row_ms``). Registers and spills of
    the instantiations this rank runs (``ptxas``)."""
    from repro_torch.core.mttkrp import cp_chain_psram
    from repro_torch.kernels import ordered_fold as of
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.sparse.stream import _chain_stream, _segment_blocks

    mode = csf.mode_order[0]
    rows, rank = csf.shape[mode], factors[0].shape[1]
    coords, seg_ptr, seg_rows, run, _, long_runs = _chain_stream(csf)
    vals, fs = csf.values, tuple(factors)
    k = len(fs) - 1
    local, n_seg = _segment_blocks(csf, cfg.rows)[:2]
    zeros = lambda: torch.zeros((rows, rank), device="cuda")

    def eager(out, psram=True, ptr=seg_ptr, rws=seg_rows, lng=long_runs):
        return of.ordered_chain_fold(out, coords, vals, fs, mode, ptr, rws, longest_run=run,
                                     long_runs=lng, psram=psram, adc_bits=adc_bits)

    def blocked(psram=True):
        return ss.blocked_chain_segment_sum(coords, vals, local, fs, mode, n_seg, psram=psram,
                                            adc_bits=adc_bits)

    got = eager(zeros())
    layout = dict(of.ordered_fold.last_psram)
    idx = csf.expanded_indices()
    want = of.ordered_fold(zeros(), cp_chain_psram(idx, vals, fs, mode, adc_bits), idx[:, mode])
    ec = {"bit_equal_to_plain": bool(torch.equal(got, want)),
          "repeatable": bool(torch.equal(eager(zeros()), got)),
          "finite": bool(torch.isfinite(got).all()),
          "max_abs_err": float((got - want).abs().max()),
          "long_runs": long_runs.numel(), "layout": layout}
    del got, want
    parts = blocked()
    want_parts = ss.blocked_segment_sum(ss.padded_chain(coords, vals, local, fs, mode, True,
                                                        adc_bits), local, n_seg)
    bc = {"bit_equal_to_plain": bool(torch.equal(parts, want_parts)),
          "repeatable": bool(torch.equal(blocked(), parts)),
          "finite": bool(torch.isfinite(parts).all()),
          "max_abs_err": float((parts - want_parts).abs().max())}
    b = parts.shape[0]
    del parts, want_parts
    case = {"mode": mode, "nnz": csf.nnz, "rank": rank, "adc_bits": adc_bits,
            "longest_run": run, "blocks": b, "n_seg": n_seg, "eager": ec, "blocked": bc}
    if not all(c["bit_equal_to_plain"] and c["repeatable"] and c["finite"] for c in (ec, bc)):
        raise AssertionError(f"a quantized chain route disagrees with its plain version or "
                             f"itself: {case}")
    if layout["clusters"] != long_runs.numel() or (
            long_runs.numel() and layout["cluster_ctas"] != CHAIN_CLUSTER):
        raise AssertionError(f"the quantized chain route did not give each long run a cluster "
                             f"of {CHAIN_CLUSTER} CTAs: {case}")
    buf = zeros()
    ec["ms"] = time_ms(torch, lambda: eager(buf), warmup=1, iters=3, reps=2)
    ec["exact_ms"] = time_ms(torch, lambda: eager(buf, False), warmup=1, iters=3, reps=2)
    if long_runs.numel():                # the head row's cluster alone
        h = int(long_runs[0])
        head = (seg_ptr[h:h + 2].contiguous(), seg_rows[h:h + 1].contiguous(),
                torch.zeros(1, dtype=torch.int64, device="cuda"))
        ec["head_row_nnz"] = int(seg_ptr[h + 1] - seg_ptr[h])
        ec["head_row_ms"] = time_ms(torch, lambda: eager(buf, True, *head), warmup=1, iters=3,
                                    reps=1)
    ec["plain_ms"] = time_ms(torch, lambda: of.ordered_chain_fold_torch(
        buf, coords, vals, fs, mode, seg_ptr, seg_rows, psram=True, adc_bits=adc_bits),
        warmup=1, iters=2, reps=1)
    others = [f for d, f in enumerate(fs) if d != mode]
    ec.update(psram_bounds(csf.nnz, rank, k, nbytes(coords, vals, seg_ptr, seg_rows, *others)
                           + 2 * 4 * rows * rank))
    ec["ptxas"] = ptxas_of("ordered_fold", {      # a plain launch's batch, a cluster launch's
        f"ordered_psram_kernel<{rank}, {batch}>": f"ordered_psram_kernelILi{rank}ELi{batch}E"
        for batch in (2048, 4096)})
    bc["ms"] = time_ms(torch, lambda: blocked(), warmup=1, iters=3, reps=2)
    bc["exact_ms"] = time_ms(torch, lambda: blocked(False), warmup=1, iters=3, reps=2)
    bc["plain_ms"] = time_ms(torch, lambda: ss.blocked_chain_segment_sum_torch(
        coords, vals, local, fs, mode, n_seg, True, adc_bits), warmup=1, iters=2, reps=1)
    bc.update(psram_bounds(csf.nnz, rank, k, nbytes(coords, vals, local, *others)
                           + 4 * b * n_seg * rank))
    bc["ptxas"] = ptxas_of("segment_sum", {
        f"segment_chain_kernel<{k}, {vec}, true>": f"segment_chain_kernelILi{k}ELb{int(vec)}ELb1E"
        for vec in (True, False)})
    return case


def small_psram_cases(torch):
    """Both quantized chain routes against their plain versions on the CPU
    (bit-equal): a 4-bit ADC, R % 4 != 0, a rank over one column tile with 4
    modes, a ragged last block, and runs of ``CHAIN_LONG_RUN`` nonzeros or
    more (the clusters)."""
    from repro_torch.kernels import ordered_fold as of
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.sparse import csf_for_mode, powerlaw_coo
    from repro_torch.sparse.stream import _chain_stream, _segment_blocks

    cases = []
    for shape, nnz, rank, mode, bits in [((300, 200, 100), 60000, 32, 0, 16),
                                         ((300, 200, 100), 60000, 5, 1, 4),
                                         ((50, 12, 9, 7), 20000, 48, 2, 8),
                                         ((40, 3000, 200), 400000, 32, 0, 16)]:
        coo = powerlaw_coo(15, shape, nnz=nnz, rank=4, alpha=1.6, device="cuda")
        csf = csf_for_mode(coo, mode)
        gen = torch.Generator(device="cuda").manual_seed(rank)
        fs = tuple(torch.randn((s, rank), generator=gen, device="cuda") for s in shape)
        coords, seg_ptr, seg_rows, run, _, long_runs = _chain_stream(csf)
        local, n_seg = _segment_blocks(csf, 256)[:2]
        cpu = lambda t: t.cpu()
        out = torch.zeros((shape[mode], rank), device="cuda")
        got = of.ordered_chain_fold(out, coords, csf.values, fs, mode, seg_ptr, seg_rows,
                                    longest_run=run, long_runs=long_runs, psram=True,
                                    adc_bits=bits)
        layout = dict(of.ordered_fold.last_psram or {}) if rank in of.TEMPLATE_RANKS else None
        want = of.ordered_chain_fold_torch(cpu(out).zero_(), cpu(coords), cpu(csf.values),
                                           tuple(map(cpu, fs)), mode, cpu(seg_ptr),
                                           cpu(seg_rows), psram=True, adc_bits=bits)
        parts = ss.blocked_chain_segment_sum(coords, csf.values, local, fs, mode, n_seg,
                                             psram=True, adc_bits=bits)
        want_parts = ss.blocked_chain_segment_sum_torch(cpu(coords), cpu(csf.values),
                                                        cpu(local), tuple(map(cpu, fs)), mode,
                                                        n_seg, True, bits)
        case = {"shape": list(shape), "nnz": csf.nnz, "rank": rank, "mode": mode,
                "adc_bits": bits, "longest_run": run, "long_runs": long_runs.numel(),
                "layout": layout,
                "max_abs_err": max(float((got.cpu() - want).abs().max()),
                                   float((parts.cpu() - want_parts).abs().max())),
                "eager_bit_equal_to_cpu": bool(torch.equal(got.cpu(), want)),
                "blocked_bit_equal_to_cpu": bool(torch.equal(parts.cpu(), want_parts))}
        cases.append(case)
        if not (case["eager_bit_equal_to_cpu"] and case["blocked_bit_equal_to_cpu"]):
            raise AssertionError(f"a quantized chain route is not bit-equal to the CPU: {case}")
        if layout is not None and layout["clusters"] != long_runs.numel():
            raise AssertionError(f"the long runs did not take clusters: {case}")
    if not any(c["long_runs"] for c in cases):
        raise AssertionError("no small quantized case had a run of CHAIN_LONG_RUN nonzeros")
    return cases


# ------------------------------------------------------- the ordered fold


def step_cuts(torch, csf, step: int):
    """The parent's run cuts for its stepped ``stream_mttkrp`` on the card:
    the sorted stream's row runs cut at every ``step`` boundary, ``(seg_ptr,
    seg_rows, chunk_seg)`` with ``seg_ptr (n_seg + 1,)`` int64 stream
    offsets and ``seg_rows (n_seg,)`` int64 rows on the card, and
    ``chunk_seg`` the host list of each step's first segment (and the total
    last): step ``c`` folds segments ``[chunk_seg[c], chunk_seg[c + 1])``."""
    import numpy as np

    rid = csf.row_of_nonzero().astype(np.int64)
    nnz = len(rid)
    starts = np.flatnonzero(np.r_[True, rid[1:] != rid[:-1]]) if nnz else np.zeros(0, np.int64)
    bounds = np.arange(0, nnz, step, dtype=np.int64)
    cuts = np.union1d(starts, bounds)
    chunk_seg = np.searchsorted(cuts, np.r_[bounds, nnz]).tolist()
    return (torch.as_tensor(np.r_[cuts, nnz].astype(np.int64), device="cuda"),
            torch.as_tensor(rid[cuts], device="cuda"), chunk_seg)


def fold_chunks_case(torch, csf, factors):
    """The exact-fit MTTKRP of a ``hopper`` sweep (``stream_mttkrp`` on one
    mode at full size) on both of the ordered fold's routes, in one run:

    * ``chain`` — what ``stream_mttkrp`` launches: one chain-route launch
      over the whole stream, a CTA per root fiber, ``d`` formed in the
      kernel. Its time (CUDA events, the call's one launch), its plain
      version's (``cp_chain_exact`` over the stream + ``index_add_``: on the
      card atomic, unordered), its byte bound (the non-target coordinates,
      values, runs and non-target factors read once, ``out`` read and
      written once), the chain floor (the
      longest run's dependent adds at ``FADD_CYCLES`` each, at the card's
      top SM clock), the factor rows it gathers from L2 (a count, no rate
      is sourced for it) and the call's device time by kernel
      (``call_split``).
    * ``stepped`` — the parent's ``stream_mttkrp``, composed from its parts:
      ``cp_chain_exact`` and one fold-route launch (``_fold_runs``) per
      64Ki-nonzero step over its run cuts (:func:`step_cuts`). Its call
      time and split, and the fold route's
      device time a launch (the steps' ``d`` formed first; the whole
      stream's launches captured in one CUDA graph) beside its byte bound,
      its plain version (``index_add_``) and the library call (the same).

    The chain route is held BIT-EQUAL to the stepped route (which is
    bit-equal to the CPU) and repeatable; both within the worst case of two
    recursive f32 sums of each row's run of the plain version."""
    from repro_torch.core.mttkrp import cp_chain_exact
    from repro_torch.kernels import ordered_fold as of
    from repro_torch.sparse.stream import _DEFAULT_EXEC_NNZ, _chain_stream

    mode = csf.mode_order[0]
    rows, rank = csf.shape[mode], factors[0].shape[1]
    idx, vals = csf.expanded_indices(), csf.values
    fs = tuple(factors)
    ids = idx[:, mode].long()
    coords, seg_ptr, seg_rows, run, *_ = _chain_stream(csf)
    step = _DEFAULT_EXEC_NNZ
    step_ptr, step_rows, chunk_seg = step_cuts(torch, csf, step)
    los = list(range(0, csf.nnz, step))
    ptr_host = step_ptr.cpu()
    step_long = [torch.as_tensor(of.find_long_runs(ptr_host[chunk_seg[c]:chunk_seg[c + 1] + 1]),
                                 device="cuda") for c in range(len(los))]
    zeros = lambda: torch.zeros((rows, rank), device="cuda")

    def chain(out):                      # as stream_mttkrp launches it
        return of.ordered_chain_fold(out, coords, vals, fs, mode, seg_ptr, seg_rows,
                                     longest_run=run)

    def stepped(out):                    # as the parent's stream_mttkrp ran it
        for c, lo in enumerate(los):
            d = cp_chain_exact(idx[lo:lo + step], vals[lo:lo + step], fs, mode)
            of._fold_runs(out, d, step_ptr, step_rows, chunk_seg[c], chunk_seg[c + 1], lo,
                          long_runs=step_long[c])
        return out

    before = dict(of.ordered_fold.routes)
    got = chain(zeros())
    torch.cuda.synchronize()
    launched = {r: of.ordered_fold.routes[r] - before[r] for r in before}
    want_steps = stepped(zeros())
    plain = of.ordered_chain_fold_torch(zeros(), coords, vals, fs, mode, seg_ptr, seg_rows)
    mag = of.ordered_chain_fold_torch(zeros(), coords, vals.abs(), tuple(f.abs() for f in fs),
                                      mode, seg_ptr, seg_rows)
    diff = (got - plain).abs()
    case = {
        "mode": mode, "nnz": csf.nnz, "rank": rank, "runs": int(seg_rows.numel()),
        "longest_run": run, "launched": launched,
        "bit_equal_to_stepped": bool(torch.equal(got, want_steps)),
        "repeatable": bool(torch.equal(chain(zeros()), got)),
        "finite": bool(torch.isfinite(got).all()),
        "max_abs_err": float(diff.max()),
        "max_err_over_magnitude": float((diff / mag.clamp_min(1e-30)).max()),
    }
    del plain, mag, diff, want_steps
    if not (case["bit_equal_to_stepped"] and case["repeatable"] and case["finite"]
            and launched == {"fold": 0, "chain": 1, "chain_psram": 0}
            and case["max_err_over_magnitude"] <= 2 * (run - 1) * 2.0 ** -24):
        raise AssertionError(f"the chain route disagrees with the stepped route or its plain "
                             f"version: {case}")
    buf = zeros()
    case["ms"] = time_ms(torch, lambda: chain(buf))
    case["plain_ms"] = time_ms(torch, lambda: of.ordered_chain_fold_torch(
        buf, coords, vals, fs, mode, seg_ptr, seg_rows), iters=3, reps=1)
    case["split"] = call_split(torch, lambda: chain(zeros()), 1)
    # what the route must move: the target column is not read (a run's row
    # stands for it), the non-target factors at least once
    others = [f for d, f in enumerate(fs) if d != mode]
    moved = nbytes(coords, vals, seg_ptr, seg_rows, *others) + 2 * 4 * rows * rank
    case["bound_ms"] = 1e3 * moved / HBM_BYTES_PER_S
    case["bound_by"] = "bytes"
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()[0])
    case["chain_floor_ms"] = run * FADD_CYCLES / (clock_mhz * 1e3)
    case["sm_clock_max_mhz"] = clock_mhz
    case["l2_gather_bytes"] = csf.nnz * (len(fs) - 1) * rank * 4
    # the stepped route: the whole call, then the fold route's launches alone
    case["stepped"] = {"launches_per_call": len(los),
                       "ms": time_ms(torch, lambda: stepped(buf), warmup=1, iters=3, reps=1),
                       "split": call_split(torch, lambda: stepped(zeros()), len(los))}
    d = cp_chain_exact(idx, vals, fs, mode)
    parts = [(d[lo:lo + step], ids[lo:lo + step],
              (chunk_seg[c], chunk_seg[c + 1], lo, step_long[c])) for c, lo in enumerate(los)]

    def fold_steps(out):
        for dc, _, (first, last, lo, long_runs) in parts:
            of._fold_runs(out, dc, step_ptr, step_rows, first, last, lo, long_runs=long_runs)
        return out

    def index_add_steps(out):
        for dc, ic, _ in parts:
            of.ordered_fold_torch(out, dc, ic)
        return out

    n = len(parts)
    fold = {"ms": graph_ms(torch, [lambda: fold_steps(buf)], iters=3) / n,
            "plain_ms": graph_ms(torch, [lambda: index_add_steps(buf)], iters=3) / n}
    fold["library_ms"] = fold["plain_ms"]
    fold["library"] = "index_add_ per step (the plain version itself)"
    fold_moved = nbytes(d, step_ptr, step_rows) + 2 * 4 * rank * step_rows.numel()
    fold["bound_ms"] = 1e3 * fold_moved / HBM_BYTES_PER_S / n
    fold["bound_by"] = "bytes"
    case["stepped"]["fold_launch"] = fold
    del d, parts
    return case


def stream_fold_check(torch, csf, factors):
    """The exact eager ``stream_mttkrp`` at full size on the skewed mode 0
    (its head row: 2.5 M nonzeros) through the chain route: one chain-route
    launch and no fold-route launch a call, the same bits twice on the card
    and on the CPU from the same tree, values and factors (the CPU's steps
    and index_add_ add in stream order). Also the head row's launch alone:
    the chain of its 2.5 M dependent adds on one SM."""
    from repro_torch.kernels import ordered_fold as of
    from repro_torch.sparse.formats import CSF
    from repro_torch.sparse.stream import _chain_stream, stream_mttkrp

    torch.cuda.synchronize()
    before = dict(of.ordered_fold.routes)
    t0 = time.perf_counter()
    got = stream_mttkrp(csf, factors)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0           # with the host's run cuts, made once
    launched = {r: of.ordered_fold.routes[r] - before[r] for r in before}
    again = stream_mttkrp(csf, factors)
    warm_ms = time_ms(torch, lambda: stream_mttkrp(csf, factors), warmup=0, iters=3, reps=1)
    coords, seg_ptr, seg_rows, *_ = _chain_stream(csf)
    lengths = csf.fiber_lengths()
    h = int(lengths.argmax())
    head = (coords, csf.values, tuple(factors), csf.mode_order[0],
            seg_ptr[h:h + 2].contiguous(), seg_rows[h:h + 1].contiguous())
    head_out = torch.zeros((csf.shape[csf.mode_order[0]], factors[0].shape[1]), device="cuda")
    head_ms = time_ms(torch, lambda: of.ordered_chain_fold(
        head_out, *head, longest_run=int(lengths[h])), warmup=1, iters=3, reps=1)
    host = CSF(shape=csf.shape, mode_order=csf.mode_order, fids=csf.fids, fptr=csf.fptr,
               values=csf.values.cpu())
    host.__dict__["_expanded_np"] = csf.expanded_indices_np()
    t0 = time.perf_counter()
    want = stream_mttkrp(host, tuple(f.cpu() for f in factors))
    case = {
        "mode": csf.mode_order[0], "nnz": csf.nnz, "longest_run": int(lengths[h]),
        "launched": launched, "card_first_s": card_s, "card_warm_ms": warm_ms,
        "head_row_ms": head_ms, "cpu_s": time.perf_counter() - t0,
        "repeatable": bool(torch.equal(again, got)),
        "bit_equal_to_cpu": bool(torch.equal(got.cpu(), want)),
        "max_abs_err": float((got.cpu() - want).abs().max()),
    }
    if not (case["repeatable"] and case["bit_equal_to_cpu"]
            and launched == {"fold": 0, "chain": 1, "chain_psram": 0}):
        raise AssertionError(f"stream_mttkrp on the card is not one in-order chain-route "
                             f"launch: {case}")
    return case


def small_fold_cases(torch):
    """The fold route on its own against the CPU's index_add_ (bit-equal):
    16-byte and 4-byte copies, a misaligned d, one-row stages (R over
    2048), runs longer than FOLD_LONG_RUN (every run of the last case),
    empty rows, a nonzero start; each with d read in place and through a
    gather ``order`` over a d with more rows than the stream."""
    from repro_torch.kernels.ordered_fold import ordered_fold, ordered_fold_torch

    gen = torch.Generator(device="cuda").manual_seed(14)
    cases = []
    for (n, rows, r, offset), gather in [
            (c, g) for c in [(5000, 23, 32, 0), (5000, 23, 6, 0), (5000, 23, 40, 1),
                             (300, 23, 3000, 0), (70000, 4, 32, 0)] for g in (False, True)]:
        ids = torch.randint(0, rows, (n,), generator=gen, device="cuda").sort().values
        n_d = n + 97 if gather else n
        d = torch.randn((n_d * r + offset,), generator=gen, device="cuda")[offset:].view(n_d, r)
        order = (torch.randperm(n_d, generator=gen, device="cuda")[:n] if gather else None)
        start = torch.randn((rows, r), generator=gen, device="cuda")
        got = ordered_fold(start.clone(), d, ids, order=order)
        want = ordered_fold_torch(start.cpu(), d.cpu(), ids.cpu(),
                                  order=None if order is None else order.cpu())
        case = {"n": n, "rows": rows, "rank": r, "offset": offset, "order": gather,
                "max_abs_err": float((got.cpu() - want).abs().max()),
                "bit_equal_to_cpu": bool(torch.equal(got.cpu(), want))}
        cases.append(case)
        if not case["bit_equal_to_cpu"]:
            raise AssertionError(f"ordered_fold is not bit-equal to the CPU fold: {case}")
    return cases


# ---------------------------------------------------------- kernel 6


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def flash_case(torch, b, h, hkv, s, d, dtype, causal=True, softcap=0.0, seed=0, timed=False,
               skv=None):
    """Kernel 6 against its plain version on seeded normal q/k/v (``s``
    queries, ``skv`` keys, default ``s``; see :func:`flash_check`), and with
    ``timed`` its times, bound and its design's own floor (the wgmma route's
    two-term P V; the slab route's scores formed once a slab).
    ``scaled_dot_product_attention`` takes no softcap: with ``softcap`` the
    library is timed without it, beside the kernel without it
    (``ms_no_softcap``)."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_torch,
                                                     kernel_head_dim, kernel_route)

    skv = s if skv is None else skv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, hkv, skv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, hkv, skv, d), generator=gen, device="cuda").to(dtype)
    got, case = flash_check(torch, q, k, v, causal, softcap)
    if timed:
        sc = d ** -0.5
        case["ms"] = time_ms(torch, lambda: flash_attention(q, k, v, causal=causal, softcap=softcap))
        case["plain_ms"] = time_ms(torch, lambda: flash_attention_torch(
            q, k, v, causal=causal, softcap=softcap), warmup=1, iters=3, reps=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        case["library_ms"] = time_ms(torch, lambda: sdpa(
            q, k, v, is_causal=causal, scale=sc, enable_gqa=True))
        if softcap > 0:
            case["library_softcap"] = 0.0
            case["ms_no_softcap"] = time_ms(torch, lambda: flash_attention(q, k, v,
                                                                           causal=causal))
        # unmasked (query, key) pairs: row i sees keys 0..min(i, skv - 1)
        pairs = b * h * (sum(min(i + 1, skv) for i in range(s)) if causal else s * skv)
        route = case["route"] = kernel_route(d, dtype)
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        ops_ms = 1e3 * 4.0 * d * pairs / peak
        bytes_ms = 1e3 * (nbytes(q, k, v) + nbytes(got)) / HBM_BYTES_PER_S
        case["bound_ms"] = max(ops_ms, bytes_ms)
        case["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        if route == "wgmma":
            # P V twice (hi + lo): 6 D operations a pair on the tensor cores
            case["floor_ms"] = max(1e3 * 6.0 * d * pairs / peak, bytes_ms)
        elif route == "slab":
            # f32 on the CUDA cores; each of the ceil(D / 256) slabs forms the
            # whole score (2 D a pair) before its share of P V (2 D a pair
            # over all slabs)
            dk = kernel_head_dim(d)
            case["slabs"] = slabs = -(-dk // 256)
            case["f32_bound_ms"] = max(1e3 * 4.0 * d * pairs / F32_FLOPS_PER_S, bytes_ms)
            case["floor_ms"] = max(1e3 * 2.0 * dk * (slabs + 1) * pairs / F32_FLOPS_PER_S,
                                   bytes_ms)
        case["tflops"] = 4.0 * d * pairs / (case["ms"] * 1e-3) / 1e12
    return case


def flash_check(torch, q, k, v, causal=True, softcap=0.0):
    """Kernel 6 against its plain version (an exact f32 softmax, rounded once
    to the input dtype) on q (B, H, S, D), k/v (B, Hkv, S, D). f32: within
    1e-5 of max |out|. bf16: every element within one bf16 ulp of the plain
    version plus 2^-16 of sum_j p_j |v_j| (the plain version on |v|): the
    envelope of the reassociated f32 sums and of the kernel's two-term bf16
    split of the softmax weights. Returns (kernel output, report)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_torch

    b, h, s, d = q.shape
    hkv, skv, dtype = k.shape[1], k.shape[2], q.dtype
    got = flash_attention(q, k, v, causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    want = flash_attention_torch(q, k, v, causal=causal, softcap=softcap)
    diff = (got.float() - want.float()).abs()
    top = float(want.abs().max())
    case = {
        "shape": [b, h, hkv, s, d] + ([skv] if skv != s else []),
        "dtype": str(dtype).replace("torch.", ""),
        "causal": causal, "softcap": softcap,
        "max_abs_err": float(diff.max()), "max_err_over_max": float(diff.max()) / max(top, 1e-30),
        "finite": bool(torch.isfinite(got).all()),
        "deterministic": bool(torch.equal(flash_attention(q, k, v, causal=causal,
                                                          softcap=softcap), got)),
    }
    if dtype == torch.float32:
        ok = float(diff.max()) <= 1e-5 * top
    else:
        ulp = bf16_ulp(torch, want)
        mag = flash_attention_torch(q, k, v.abs(), causal=causal, softcap=softcap).float()
        envelope = ulp + 2.0 ** -16 * mag
        # the largest error as a share of its element's envelope (<= 1 passes)
        case["max_err_over_envelope"] = float((diff / envelope).max())
        case["share_over_one_ulp"] = float((diff > ulp).float().mean())
        case["share_differing"] = float((diff > 0).float().mean())
        ok = case["max_err_over_envelope"] <= 1.0
        del ulp, mag, envelope
    if not (ok and case["finite"] and case["deterministic"]):
        raise AssertionError(f"flash_attention disagrees with its plain version: {case}")
    return got, case


def small_flash_cases(torch):
    """f32 and bf16; MHA / GQA / MQA; non-causal; softcap 50 at gemma2's
    widths (H=32, Hkv=16, D=128); S in {64, 128, 384}; a ragged S; causal
    with Sq != Skv both ways (top-left aligned); D in {160, 192, 256, 320,
    512} (the padding to 256, the bf16 kernel's D = 256, the slab kernel);
    and a shape the reference refuses, which must raise."""
    from repro_torch.kernels.flash_attention import flash_attention

    cases = []
    for i, (b, h, hkv, s, d, causal, softcap, skv) in enumerate([
        (2, 4, 4, 128, 64, True, 0.0, None),       # MHA
        (2, 8, 2, 384, 128, True, 0.0, None),      # GQA
        (1, 8, 1, 64, 32, True, 0.0, None),        # MQA
        (2, 4, 2, 384, 64, False, 0.0, None),      # non-causal
        (1, 32, 16, 128, 128, True, 50.0, None),   # softcap at gemma2's widths
        (1, 4, 2, 100, 128, True, 0.0, None),      # a partial q tile and kv tile
        (1, 8, 2, 128, 128, True, 0.0, 384),       # causal, Sq < Skv
        (1, 8, 2, 384, 128, True, 0.0, 128),       # causal, Sq > Skv
        # head dims above 128: 160 and 192 padded to 256, 256 itself (the
        # bf16 kernel's 64-key tiles), 320 and 512 on the slab kernel
        (1, 8, 2, 256, 160, True, 50.0, None),
        (1, 8, 2, 384, 192, True, 0.0, None),
        (2, 16, 8, 384, 256, True, 50.0, None),    # gemma-2-9b's heads and softcap
        (1, 4, 2, 100, 256, True, 0.0, None),      # a partial q tile and kv tile
        (1, 8, 2, 128, 256, True, 0.0, 384),       # causal, Sq < Skv
        (1, 8, 2, 256, 320, True, 50.0, None),
        (1, 8, 2, 128, 512, False, 0.0, 256),      # non-causal, Sq != Skv
    ]):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(flash_case(torch, b, h, hkv, s, d, dtype, causal, softcap, seed=20 + i,
                                    skv=skv))
    z = torch.zeros((1, 2, 192, 64), device="cuda", dtype=torch.bfloat16)
    try:
        flash_attention(z, z, z)          # 192 % min(128, 192): the reference asserts
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention took a shape the reference refuses")
    return cases


def planted_operands(torch, m, k, n, gen):
    """x (m, k) and w (k, n), seeded normal, with row 0 of x at its absolute
    maximum everywhere and column 1 of w at one magnitude, their signs
    matched: both quantize to +-127 with equal signs, so that element's
    integer sum is the full scale 127^2 K and its unclipped ADC code
    levels / 2, one past the rail."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / 8
    signs = torch.where(torch.rand(k, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    x[0] = 0.75 * signs
    w[:, 1] = 0.125 * signs
    return x, w


def unsaturated_case(torch, m, k, n, seed, adc_bits=16):
    """Kernel 2 with ``saturate=False`` (the epilogue launched with no clip)
    on :func:`planted_operands`: bit-equal to
    ``psram_matmul_torch(saturate=False)``, the planted element's code
    ``levels / 2``, every other element equal to ``saturate=True``; both
    timed in turns."""
    from repro_torch.core.quantization import QMAX, quantize_symmetric
    from repro_torch.kernels.psram_matmul import (_aligned, _route, psram_matmul,
                                                  psram_matmul_torch)

    x, w = planted_operands(torch, m, k, n, torch.Generator(device="cuda").manual_seed(seed))
    qx, sx = quantize_symmetric(x, axis=-1)
    qw, sw = quantize_symmetric(w, axis=0)
    got = psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits, saturate=False)
    torch.cuda.synchronize()
    want = psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits, saturate=False)
    sat = psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits)
    ones_m = torch.ones((m, 1), device="cuda")
    ones_n = torch.ones((1, n), device="cuda")
    lsb = 2.0 * QMAX * QMAX * k / 2 ** adc_bits
    code = psram_matmul(qx, qw, ones_m, ones_n, adc_bits=adc_bits, saturate=False)[0, 1] / lsb
    case = {
        "shape": [m, k, n], "route": _route(m, k, n, _aligned(qx, qw)), "adc_bits": adc_bits,
        "bit_equal": bool(torch.equal(got, want)),
        "max_abs_err": float((got - want).abs().max()),
        "planted_code": float(torch.round(code)),
        "differs_from_saturated_at": (got != sat).nonzero().tolist(),
    }
    # in turns: saturated, unsaturated, unsaturated, saturated
    runs = [time_ms(torch, lambda sat=sat: psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits,
                                                        saturate=sat))
            for sat in (True, False, False, True)]
    case.update(ms=statistics.fmean(runs[1:3]), saturated_ms=statistics.fmean(runs[::3]),
                runs_ms=runs)
    if not (case["bit_equal"] and case["planted_code"] == 2 ** adc_bits // 2
            and case["differs_from_saturated_at"] == [[0, 1]]):
        raise AssertionError(f"kernel 2 with saturate=False: {case}")
    return case


def unsaturated_split_cases(torch, mesh, adc_bits=16) -> list:
    """:func:`unsaturated_case`'s planted operands at ``UNSAT_SHAPES``
    through ``psram_linear(saturate=False)`` on a weight placed row-parallel
    (K on ``"model"``) on ``mesh``: the K split's int32 sums (decode rows on
    the slice that quantizes its own rows, the rest on ``wgmma``) + the
    epilogue launched with no clip, bit-equal to
    ``psram_matmul_torch(saturate=False)`` on the whole operands."""
    from repro_torch.core.photonic_layer import program_weights, psram_linear
    from repro_torch.core.quantization import quantize_symmetric
    from repro_torch.dist.placement import distribute, full
    from repro_torch.dist.sharding import logical_to_spec
    from repro_torch.kernels.psram_matmul import (psram_adc_epilogue, psram_matmul_int32,
                                                  psram_matmul_int32_rows, psram_matmul_torch)

    counters = (psram_matmul_int32, psram_matmul_int32_rows, psram_adc_epilogue)
    cases = []
    for i, (m, k, n) in enumerate(UNSAT_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(90 + i)
        x, w = planted_operands(torch, m, k, n, gen)
        qx, sx = quantize_symmetric(x, axis=-1)
        prog = program_weights(w)
        want = psram_matmul_torch(qx, prog["q"], sx, prog["scale"], adc_bits=adc_bits,
                                  saturate=False)
        wd = distribute(w, mesh, logical_to_spec(("qdim", "embed"), w.shape, mesh))
        xd = distribute(x, mesh, logical_to_spec(("batch", None), x.shape, mesh))
        torch.cuda.synchronize()
        before = [fn.launches for fn in counters]
        with torch.inference_mode():
            got = full(psram_linear(xd, program_weights(wd), adc_bits=adc_bits, saturate=False))
        torch.cuda.synchronize()
        launched = {fn.__name__: fn.launches - b for fn, b in zip(counters, before)}
        case = {"shape": [m, k, n], "bit_equal": bool(torch.equal(got, want)),
                "max_abs_err": float((got - want).abs().max()), "launches": launched}
        sums = "psram_matmul_int32" if m > 16 else "psram_matmul_int32_rows"
        if not (case["bit_equal"] and launched["psram_adc_epilogue"] == 1
                and launched[sums] == 1):
            raise AssertionError(f"psram_linear(saturate=False) on the K split: {case}")
        cases.append(case)
    return cases


def group_decode_case(torch, cfg, params, seed=37) -> dict:
    """``blocks.group_decode`` (the write-through decode) on the card: group
    0 of ``params``, one token of seeded hidden state for ``SERVE_BATCH``
    rows against a seeded ``GROUP_DECODE_CACHE``-slot cache at position
    ``GROUP_DECODE_POS``. The cache it writes in place is bit-equal to
    ``group_decode_tokens`` + ``apply_decode_deltas`` on a copy. Its output
    attends over the written cache in one softmax, where the read-only
    decode combines the cache with the token as two blocks (the history's
    weights rounded to the cache's dtype), so the two are held within
    ``GROUP_DECODE_TOL`` of max |x|, the error reported."""
    from repro_torch.models.blocks import (apply_decode_deltas, group_decode,
                                           group_decode_tokens, group_layout)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = params["embed"].dtype
    shape = (SERVE_BATCH, GROUP_DECODE_CACHE, cfg.n_kv_heads, cfg.head_dim)
    layout = group_layout(cfg)
    if any(d.mixer != "attn" for d in layout):
        raise ValueError("group_decode_case seeds attention caches only")
    cache = {f"layer{i}": {name: torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for name in ("k", "v")} for i in range(len(layout))}
    x = torch.randn((SERVE_BATCH, 1, cfg.d_model), generator=gen, device="cuda").to(dtype)
    copy = {key: {name: t.clone() for name, t in layer.items()} for key, layer in cache.items()}
    leaves = {(key, name): t for key, layer in cache.items() for name, t in layer.items()}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_x, got_cache = group_decode(params["blocks"][0], x, cfg, cache, GROUP_DECODE_POS)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        want_x, deltas = group_decode_tokens(params["blocks"][0], x, cfg, copy,
                                             GROUP_DECODE_POS)
        apply_decode_deltas([copy], [deltas], cfg, GROUP_DECODE_POS)
    err = float((got_x.float() - want_x.float()).abs().max())
    top = float(want_x.float().abs().max())
    case = {
        "arch": cfg.name, "batch": SERVE_BATCH, "cache": GROUP_DECODE_CACHE,
        "cache_pos": GROUP_DECODE_POS, "dtype": str(dtype).replace("torch.", ""),
        "cache_bit_equal": all(torch.equal(got_cache[k][n], copy[k][n]) for k, n in leaves),
        "written_in_place": all(got_cache[k][n] is t for (k, n), t in leaves.items()),
        "x_max_abs_err": err, "x_err_over_max": err / max(top, 1e-30),
        "finite": bool(torch.isfinite(got_x).all()), "wall_ms": wall_ms,
    }
    if not (case["cache_bit_equal"] and case["written_in_place"] and case["finite"]
            and case["x_err_over_max"] <= GROUP_DECODE_TOL):
        raise AssertionError(f"group_decode strays from the read-only decode: {case}")
    return case


# ------------------------------------------------------------ serving


def serve_run(torch, cfg, params, prompts, eng_cls, zero_counts, read_counts, frames=None,
              new=SERVE_NEW, profiled_steps=8):
    """One ``ServeEngine.generate`` of ``new`` tokens (after a short warm-up)
    with the launch counters set to 0 just before it and read just after,
    then its prefill and a decode step timed alone, ``profiled_steps`` decode
    steps and a prefill under the profiler, and the first decode step's
    logits held against ``forward`` on prompt + token. ``frames``: the
    encoder-decoder's input. Returns (report, launches, prefill logits,
    engine, generated tokens)."""
    from repro_torch.models.registry import get_module

    mod = get_module(cfg)
    lead = () if frames is None else (frames,)
    gen_kw = {} if frames is None else {"frames": frames}
    b, p = prompts.shape
    eng = eng_cls(cfg, params, max_len=p + new, device="cuda")
    eng.generate(prompts, p, 2, **gen_kw)                         # warm-up
    zero_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, p, new, **gen_kw)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    out = {"generate_s": total_s, "tokens_per_s": b * new / total_s,
           "tokens_shape": list(toks.shape),
           "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab_size)).all())}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = eng.prefill_fn(params, *lead, prompts)
        torch.cuda.synchronize()
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        tok = logits.argmax(-1).to(torch.int32)
        first, cache = eng.step_fn(params, cache, tok, p)
        torch.cuda.synchronize()
        step_ms = []
        for i in range(1, 9):
            t0 = time.perf_counter()
            eng.step_fn(params, cache, tok, p + i)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        out["decode_ms_per_step"] = statistics.median(step_ms)
        out["decode_tokens_per_s"] = b / (1e-3 * out["decode_ms_per_step"])
        t0 = time.perf_counter()
        out["decode_profile"] = profile_decode(torch, eng, params, cache, tok, p + 9,
                                               profiled_steps)
        out["prefill_profile"] = profile_prefill(torch, eng, params, prompts, frames=frames)
        out["profiles_s"] = time.perf_counter() - t0
        full = mod.forward(params, *lead, torch.cat([prompts, tok[:, None]], dim=1), cfg)[:, -1]
        out["decode_vs_forward_rel_l2"] = float(torch.linalg.norm(first - full)
                                                / torch.linalg.norm(full))
        out["finite"] = bool(torch.isfinite(logits).all() and torch.isfinite(first).all())
    return out, launches, logits, eng, toks


def device_profile(torch, prof, wall_ms: float, n: int, per: str) -> dict:
    """What a ``torch.profiler`` window over ``n`` like units of work saw:
    host ms, the card's busy ms (the sum of its kernels' times), the idle
    share, kernel launches, kernel 2's ms, launches and kernel names, and
    the kernels that take the most device time — each ``per`` unit."""

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if not kernels or busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    k2 = [e for e in kernels if "psram_matmul" in e.key]
    return {
        f"host_ms{per}": wall_ms / n,
        f"device_busy_ms{per}": busy_ms / n,
        "idle_share": 1.0 - busy_ms / wall_ms,
        f"kernel_launches{per}": sum(e.count for e in kernels) / n,
        f"kernel2_ms{per}": sum(dev_us(e) for e in k2) / 1e3 / n,
        f"kernel2_launches{per}": sum(e.count for e in k2) / n,
        "kernel2_names": sorted({e.key[:60] for e in k2}),
        "top_kernels": [{"name": e.key[:90], f"ms{per}": dev_us(e) / 1e3 / n,
                         f"launches{per}": e.count / n} for e in top],
    }


def profile_decode(torch, eng, params, cache, tok, pos: int, n: int) -> dict:
    """``n`` decode steps from cache position ``pos`` under
    ``torch.profiler`` (:func:`device_profile`, a step the unit). The
    profiler's own cost inflates the host time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            eng.step_fn(params, cache, tok, pos + i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return {"steps": n, **device_profile(torch, prof, wall_ms, n, "_per_step")}


def profile_prefill(torch, eng, params, prompts, attempts: int = 3, frames=None) -> dict:
    """One prefill of ``prompts`` under ``torch.profiler``
    (:func:`device_profile`): kernel 2's share of its device time. A window
    whose kernel-2 records fall short of the launches kernel 2's wrapper
    counted in it lost records (it happens: 247 of 252 once) and is
    profiled again, at most ``attempts`` times; the last window is returned
    either way, with ``attempts`` and the count ``kernel2_counted``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.psram_matmul import psram_matmul

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = psram_matmul.launches
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.prefill_fn(params, *(() if frames is None else (frames,)), prompts)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        counted = psram_matmul.launches - before
        out = device_profile(torch, prof, wall_ms, 1, "")
        if out["kernel2_launches"] == counted:
            break
    out["kernel2_share_of_busy"] = out["kernel2_ms"] / out["device_busy_ms"]
    out["attempts"], out["kernel2_counted"] = attempt, counted
    return out


def routes_agree(torch, eng, prompts, toks):
    """``eng.generate`` for the first ``TOKENS_CHECKED`` tokens with the
    model's module-level ``psram_matmul`` wrapped so that every call of the
    decode route is also launched on the tile route: each decode projection
    must be BIT-EQUAL across the routes, and the tokens equal to ``toks``'s
    (the main path's run). Since every projection agrees, the tile route
    would have served these tokens too."""
    import repro_torch.core.photonic_layer as photonic
    from repro_torch.kernels.psram_matmul import M_DECODE, _launch

    launch = photonic.psram_matmul
    counts = {"compared": 0, "differing": 0}

    def both(qx, qw, sx, sw, adc_bits=16, saturate=True):
        out = launch(qx, qw, sx, sw, adc_bits=adc_bits, saturate=saturate)
        if qx.shape[0] <= M_DECODE:
            counts["compared"] += 1
            tile = _launch(qx, qw, sx, sw, adc_bits=adc_bits, route="tile", saturate=saturate)
            counts["differing"] += int(not torch.equal(out, tile))
        return out

    photonic.psram_matmul = both
    try:
        again = eng.generate(prompts, prompts.shape[1], TOKENS_CHECKED)
    finally:
        photonic.psram_matmul = launch
    counts["tokens_equal"] = bool(torch.equal(again, toks[:, :TOKENS_CHECKED]))
    n_proj = 7 * eng.cfg.num_layers * TOKENS_CHECKED      # a step a token
    if counts["differing"] or counts["compared"] != n_proj or not counts["tokens_equal"]:
        raise AssertionError(f"kernel 2's routes disagree on the served decode steps "
                             f"(expected {n_proj} compared): {counts}")
    return counts


def word_ptrs(trees) -> set:
    """Addresses of the stored int8 array words in ``trees`` (param
    subtrees): the weights a kernel-2 call can be traced back to."""
    from repro_torch.models.layers import is_quantized

    def walk(t):
        if is_quantized(t):
            return {t["q"].data_ptr()}
        if isinstance(t, dict):
            return set().union(*map(walk, t.values()))
        if isinstance(t, list):
            return set().union(*map(walk, t))
        return set()

    return walk(trees)


def engine_stages(torch, eng, params, prompts, lead=()):
    """A served engine's two stages for :func:`served_matmul_cases`: one
    prefill of ``prompts`` (after the ``lead`` inputs, e.g. frames), then
    one decode step on its greedy tokens."""
    def prefill():
        return eng.prefill_fn(params, *lead, prompts)

    def step(state):
        logits, cache = state
        eng.step_fn(params, cache, logits.argmax(-1).to(torch.int32), prompts.shape[1])

    return prefill, step


def served_matmul_cases(torch, stages, layer0, want_calls, n_proj):
    """Kernel 2 held BIT-EQUAL to its plain version on the served model's own
    operands, for any served model and loop: every call that hands the
    kernel a stored word of ``layer0`` (the first layer's param subtrees:
    one, or the encoder's and the decoder's) in the two ``stages`` =
    ``(prefill, step)`` (:func:`engine_stages`, or the paged loop's prefills
    and step; ``step`` takes what ``prefill`` returns), each call on the
    route it took, and a ``wgmma`` call also held against the tile route.
    ``want_calls`` = (prefill, step) layer 0's calls by route, ``n_proj`` =
    (prefill, step) the whole model's launches by route; a route left out
    is 0. So every shape the main path gives the kernel is checked on the
    card: each projection's K and N (partial last tiles included) at the
    prefill's M and at a step's. The model's module-level ``psram_matmul``
    is wrapped for these two stages only; its launches here are not counted
    on the main path."""
    import repro_torch.core.photonic_layer as photonic
    from repro_torch.kernels.psram_matmul import _launch, psram_matmul_torch

    launch = photonic.psram_matmul
    routes = launch.routes
    ptrs = word_ptrs(layer0)
    seen = []

    def record(qx, qw, sx, sw, adc_bits=16, saturate=True):
        before = dict(routes)
        out = launch(qx, qw, sx, sw, adc_bits=adc_bits, saturate=saturate)
        if qw.data_ptr() in ptrs:
            route = next(r for r in routes if routes[r] != before[r])
            seen.append((qx, qw, sx, sw, adc_bits, out, route))
        return out

    prefill, step = stages
    calls, took = [], []
    photonic.psram_matmul = record
    try:
        with torch.inference_mode():
            state = None
            for stage in (prefill, lambda: step(state)):
                r0 = dict(routes)
                state = stage()
                torch.cuda.synchronize()
                took.append({r: routes[r] - r0[r] for r in routes})
                calls.append(seen)
                seen = []
    finally:
        photonic.psram_matmul = launch
    del state
    fill = [{r: want.get(r, 0) for r in routes} for want in n_proj]
    if took != fill:
        raise AssertionError(f"the served projections did not take the expected routes "
                             f"(prefill, decode step; {fill} asked): {took}")
    got_calls = [{r: sum(c[-1] == r for c in stage) for r in routes} for stage in calls]
    if got_calls != [{r: want.get(r, 0) for r in routes} for want in want_calls]:
        raise AssertionError(f"layer 0 made {got_calls} kernel-2 calls in a prefill and a "
                             f"decode step, not {want_calls}")
    cases = []
    for qx, qw, sx, sw, adc_bits, got, route in calls[0] + calls[1]:
        want = psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits)
        case = {"shape": [qx.shape[0], qx.shape[1], qw.shape[1]], "adc_bits": adc_bits,
                "route": route, "max_abs_err": float((got - want).abs().max()),
                "bit_equal": bool(torch.equal(got, want))}
        if route == "wgmma":
            case["bit_equal_to_tile"] = bool(torch.equal(
                _launch(qx, qw, sx, sw, adc_bits=adc_bits, route="tile"), got))
        cases.append(case)
        if not (case["bit_equal"] and case.get("bit_equal_to_tile", True)):
            raise AssertionError(f"psram_matmul differs from its plain version on the "
                                 f"served model's operands: {case}")
        del want
    return cases


# -------------------------------------------------------------------- main


# --------------------------------------------------------- the tile schedule


def sweep_splits(events: list, backend: str) -> list:
    """Per iteration of one traced ``cp_als`` run, from its ``obs`` events:
    the ``als/sweep`` span split into its ``backend/<backend>/mttkrp`` and
    ``backend/<backend>/gram`` spans and the remainder that no child span
    covers (the solve, the normalization, the host), beside the ``als/fit``
    span and the ``stream/mttkrp/execute`` span inside it (the exact-fit
    recompute). Shares are of sweep + fit. Fails unless every sweep holds
    three mttkrp spans and three gram spans."""
    spans = [e for e in events if e["ph"] == "X"]

    def inside(outer):
        lo, hi = outer["ts"], outer["ts"] + outer["dur"] + 1e-3
        return [e for e in spans if e is not outer and e["ts"] >= lo
                and e["ts"] + e["dur"] <= hi]

    fits = {e["args"]["iteration"]: e for e in spans if e["name"] == "als/fit"}
    out = []
    for sweep in (e for e in spans if e["name"] == "als/sweep"):
        held = inside(sweep)
        mttkrp = [e["dur"] for e in held if e["name"] == f"backend/{backend}/mttkrp"]
        gram = [e["dur"] for e in held if e["name"] == f"backend/{backend}/gram"]
        if len(mttkrp) != 3 or len(gram) != 3:
            raise AssertionError(f"a traced {backend} sweep holds {len(mttkrp)} mttkrp and "
                                 f"{len(gram)} gram spans, not 3 each")
        fit = fits[sweep["args"]["iteration"]]
        sweep_ms, fit_ms = sweep["dur"] / 1e3, fit["dur"] / 1e3
        mttkrp_ms, gram_ms = sum(mttkrp) / 1e3, sum(gram) / 1e3
        remainder_ms = sweep_ms - mttkrp_ms - gram_ms
        total = sweep_ms + fit_ms
        out.append({
            "iteration": sweep["args"]["iteration"], "sweep_ms": sweep_ms, "fit_ms": fit_ms,
            "mttkrp_ms": mttkrp_ms, "mttkrp_each_ms": [d / 1e3 for d in mttkrp],
            "gram_ms": gram_ms, "remainder_ms": remainder_ms,
            "fit_stream_ms": sum(e["dur"] for e in inside(fit)
                                 if e["name"] == "stream/mttkrp/execute") / 1e3,
            "mttkrp_share": mttkrp_ms / total, "gram_share": gram_ms / total,
            "fit_share": fit_ms / total, "remainder_share": remainder_ms / total,
        })
    return out


def schedule_bound(m, k, n, cfg) -> dict:
    """The least time of the function the scheduled matmul computes: its
    products, each of two int8 codes summed in int32 (``QMAX^2 * rows`` <
    2^24), unpadded at the int8 peak, against ``x`` and ``w`` read once and
    ``y`` written once (f32) at the memory rate. Beside it,
    ``f32_contraction_ms``: the padded tile stacks' f32 contraction at the
    f32 peak, the floor of the form the executor computes it in."""
    ops_ms = 1e3 * 2.0 * m * k * n / INT8_OPS_PER_S
    bytes_ms = 1e3 * 4.0 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    mp = -(-m // cfg.wavelengths) * cfg.wavelengths
    kp = -(-k // cfg.rows) * cfg.rows
    n_p = -(-n // cfg.word_cols) * cfg.word_cols
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "f32_contraction_ms": 1e3 * 2.0 * mp * kp * n_p / F32_FLOPS_PER_S}


def same_price(a, b) -> bool:
    """Two ``Estimate``s of one sparse workload agree field for field (the
    fiber lengths as arrays)."""
    import numpy as np

    return (a.backend, a.config, a.breakdown, a.time_s, a.counts, a.energy) \
        == (b.backend, b.config, b.breakdown, b.time_s, b.counts, b.energy) \
        and a.workload.rank == b.workload.rank \
        and np.array_equal(a.workload.fiber_lengths, b.workload.fiber_lengths)


def schedule_matmul_case(torch, m, k, n, cfg, seed, split=False) -> dict:
    """``api.matmul`` on its default backend (``psram-scheduled``) at one
    shape, eager and compiled (a CUDA graph captured on the first call and
    replayed): the two bit-equal and each repeatable, within ``rel_tol`` of
    ``exact``; each timed by CUDA events with its own peak device memory
    (the compiled one's first call, warm-up and capture, apart), beside its
    bound and ``torch._int_mm`` + ADC on the same float operands (timed
    only: it quantizes per row and column, not per tile). With ``split``,
    an eager call's device time by operation (``op_split``; kernel 2, the
    repository's kernel for this product, must not appear)."""
    from repro_torch import api, backends
    from repro_torch.core.quantization import QMAX, adc_transfer, quantize_symmetric
    from repro_torch.core.schedule import captured_graphs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    compiled = backends.get("psram-scheduled", cfg, compiled=True)
    eager = api.matmul(x, w, config=cfg)
    capture_peak = call_bytes_peak(torch, lambda: compiled.matmul(x, w))
    graph = compiled.matmul(x, w)
    want = api.matmul(x, w, backend="exact")
    norm = torch.linalg.norm(want)

    def library():
        qx, sx = quantize_symmetric(x, axis=-1)
        qw, sw = quantize_symmetric(w, axis=0)
        acc = torch._int_mm(qx, qw)
        return adc_transfer(acc, 2 ** cfg.adc.bits, float(QMAX) * float(QMAX) * k) * (sx * sw)

    case = {
        "shape": [m, k, n], "finite": bool(torch.isfinite(eager).all()),
        "on_card": eager.is_cuda and graph.is_cuda,
        "graph_bit_equal_to_eager": bool(torch.equal(graph, eager)),
        "eager_repeatable": bool(torch.equal(api.matmul(x, w, config=cfg), eager)),
        "graph_repeatable": bool(torch.equal(compiled.matmul(x, w), graph)),
        "rel_err": float(torch.linalg.norm(eager - want) / norm),
        "rel_err_graph": float(torch.linalg.norm(graph - want) / norm),
        "rel_tol": compiled.capabilities().rel_tol,
        "ms": time_ms(torch, lambda: api.matmul(x, w, config=cfg)),
        "graph_ms": time_ms(torch, lambda: compiled.matmul(x, w)),
        "library_ms": time_ms(torch, library),
        "library": "quantize_symmetric + torch._int_mm + ADC",
        "exact_ms": time_ms(torch, lambda: api.matmul(x, w, backend="exact")),
        **schedule_bound(m, k, n, cfg),
        "call_bytes_peak": call_bytes_peak(torch, lambda: api.matmul(x, w, config=cfg)),
        "graph_call_bytes_peak": call_bytes_peak(torch, lambda: compiled.matmul(x, w)),
        "graph_capture_bytes_peak": capture_peak,
        "captured_graphs": [[list(shape), nbytes] for shape, _, nbytes in captured_graphs()],
    }
    if split:
        case["split"] = op_split(torch, lambda: api.matmul(x, w, config=cfg),
                                 r"psram_matmul\w*_kernel")
    if not (case["finite"] and case["on_card"] and case["graph_bit_equal_to_eager"]
            and case["eager_repeatable"] and case["graph_repeatable"]
            and max(case["rel_err"], case["rel_err_graph"]) < case["rel_tol"]):
        raise AssertionError(f"the scheduled matmul: {case}")
    return case


def schedule_cpu_cases(torch, cfg) -> list:
    """The eager executor on the card bit-equal to the same on the CPU (and
    the CUDA graph's replay too) at a mid shape, a ragged one and an array
    whose ``QMAX^2 * rows`` passes 2^24 (the float64 contraction); and at a
    small shape ``psram-oracle``'s per-cycle matmul on the card bit-equal to
    the eager executor."""
    from repro_torch import backends
    from repro_torch.core.psram import PsramConfig
    from repro_torch.core.schedule import build_matmul_program, execute

    cases = []
    for (m, k, n), c in (((104, 1024, 2048), cfg), ((77, 1043, 131), cfg),
                         ((5, 1200, 6), PsramConfig(rows=1100, word_cols=4, wavelengths=3))):
        gen = torch.Generator().manual_seed(m + k + n)
        x = torch.randn((m, k), generator=gen)
        w = torch.randn((k, n), generator=gen)
        prog = build_matmul_program(m, k, n, c)
        cpu = execute(prog, x, w)
        card = execute(prog, x.cuda(), w.cuda())
        graph = execute(prog, x.cuda(), w.cuda(), compiled=True)
        cases.append({"shape": [m, k, n], "rows": c.rows,
                      "bit_equal_to_cpu": bool(torch.equal(card.cpu(), cpu)),
                      "graph_bit_equal_to_cpu": bool(torch.equal(graph.cpu(), cpu))})
    gen = torch.Generator(device="cuda").manual_seed(60)
    x = torch.randn((60, 300), generator=gen, device="cuda")
    w = torch.randn((300, 45), generator=gen, device="cuda")
    oracle = backends.get("psram-oracle", cfg).matmul(x, w)
    cases.append({"shape": [60, 300, 45], "rows": cfg.rows, "oracle_on_card": oracle.is_cuda,
                  "oracle_bit_equal_to_executor": bool(torch.equal(
                      oracle, backends.get("psram-scheduled", cfg).matmul(x, w)))})
    if not all(c.get("bit_equal_to_cpu", True) and c.get("graph_bit_equal_to_cpu", True)
               and c.get("oracle_bit_equal_to_executor", True) for c in cases):
        raise AssertionError(f"the scheduled matmul on the card differs from the CPU or the "
                             f"per-cycle oracle: {cases}")
    return cases


def main_path_trace(torch, cfg, coo, csfs, init, fd, zero_counts, read_counts,
                    sweep_ms) -> dict:
    """The ``main_path_trace`` phase: the port's tracer on the card.

    With tracing enabled, ``cp_als`` (rank 32, 3 sweeps, ``tol=0``) on
    ``hopper``, ``hopper`` with ``compiled=False``, ``psram-stream`` and
    ``psram-stream`` with ``compiled=True``, each run's ``obs`` summary and
    each sweep's split (``sweep_splits``), the factors, lambdas and fit
    bit-equal to an untraced run of the same call; the stopwatch around
    ``STOPWATCH_CALLS`` dense ``hopper`` calls at mode 0 against CUDA events
    on the same calls (and a host clock without the synchronize beside
    them); a CUDA graph capture of ``api.matmul`` on ``psram-scheduled``
    under tracing, bit-equal to the eager call; the drift report; the mesh
    timeline of mode 0's fiber lengths on ``MESH_ARRAYS`` arrays against
    the planned programs' counted cycles; the trace written by
    ``obs.write_trace`` and read back; and the median of
    ``OVERHEAD_SWEEPS`` warm ``hopper`` sweeps untraced (``sweep_ms``:
    stamped at each sweep's start, after a synchronize) and traced
    (``als/sweep`` + ``als/fit``). Leaves the tracer disabled and
    cleared."""
    from repro_torch import api, backends, obs
    from repro_torch.core.cp_als import cp_als
    from repro_torch.core.schedule import captured_graphs, clear_program_cache, count_cycles
    from repro_torch.sparse import partition_fiber_lengths

    obs.disable()
    obs.get_tracer().clear()
    torch.cuda.synchronize()
    zero_counts()
    step_s, t0 = {}, time.perf_counter()

    def run(name, kwargs, n_iter=SWEEPS):
        # the backend is built here, so it comes back wrapped while tracing
        return cp_als(None, RANK, n_iter=n_iter, sparse=coo, csfs=csfs, init=init, tol=0,
                      backend=backends.get(name, cfg, **kwargs))

    def same_state(a, b):
        return (a.fit == b.fit and a.iters == b.iters and torch.equal(a.lambdas, b.lambdas)
                and all(torch.equal(x, y) for x, y in zip(a.factors, b.factors)))

    runs = {}
    for key, name, kwargs in (("hopper", "hopper", {}),
                              ("hopper_legacy", "hopper", {"compiled": False}),
                              ("psram_stream", "psram-stream", {}),
                              ("psram_stream_compiled", "psram-stream", {"compiled": True})):
        plain = run(name, kwargs)
        start = len(obs.get_tracer().events())
        obs.enable()
        traced = run(name, kwargs)
        obs.disable()
        events = obs.get_tracer().events()[start:]
        sub = obs.Tracer()
        sub.add_events(events)
        splits = sweep_splits(events, name)
        runs[key] = {
            "backend": name, **kwargs, "bit_equal_to_untraced": same_state(plain, traced),
            "fit": traced.fit, "summary": sub.summary(), "per_sweep": splits,
            "median": {k: statistics.median(sp[k] for sp in splits)
                       for k in ("sweep_ms", "fit_ms", "mttkrp_ms", "gram_ms",
                                 "remainder_ms", "fit_stream_ms", "mttkrp_share",
                                 "fit_share", "remainder_share")},
            "stream_calls": sum(e["name"] == "stream/mttkrp/execute" for e in events),
        }
        del plain, traced
    step_s["cp_als_runs"], t0 = time.perf_counter() - t0, time.perf_counter()
    launches = read_counts()

    # the stopwatch against CUDA events on the same dense calls; the host
    # clock around the launches alone beside them. Untraced, then once traced
    xd = torch.randn(DENSE_SHAPE, generator=torch.Generator(device="cuda").manual_seed(5),
                     device="cuda")

    def dense_call():
        return api.mttkrp(xd, fd, 0, backend="hopper", config=cfg)

    dense_call()

    def stopwatch_case(recording):
        """One stopwatch around the calls beside CUDA events, with the host
        time at each edge: from the stopwatch's entry to ``start.record()``
        returning, and from ``stop.record()`` returning to its exit (which
        waits for the card)."""
        if recording:
            obs.enable()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with obs.stopwatch("smoke/stopwatch/dense_hopper", calls=STOPWATCH_CALLS) as sw:
            start.record()
            h0 = time.perf_counter()
            for _ in range(STOPWATCH_CALLS):
                dense_call()
            host_ms = 1e3 * (time.perf_counter() - h0)
            stop.record()
            h1 = time.perf_counter()
        obs.disable()
        event_ms = start.elapsed_time(stop)
        return {
            "traced": recording, "stopwatch_ms": 1e3 * sw.duration_s, "event_ms": event_ms,
            "host_clock_ms": host_ms, "excess_ms": 1e3 * sw.duration_s - event_ms,
            "entry_edge_ms": 1e3 * (h0 - sw.t0), "exit_edge_ms": 1e3 * (sw.t0 + sw.duration_s - h1),
            "within": abs(1e3 * sw.duration_s - event_ms) <= 0.1 * event_ms + 0.1}

    # the first case after other work carried the excess (0.10-2.82 ms over
    # the events in 12 whole runs, later cases <= 0.31 ms): one is run and
    # reported, not gated
    stopwatch_discarded = stopwatch_case(False)
    stopwatch_cases = [stopwatch_case(recording) for recording in (False, False, False, True)]
    del xd
    step_s["stopwatch"], t0 = time.perf_counter() - t0, time.perf_counter()

    # a CUDA graph capture of api.matmul on psram-scheduled while tracing
    m, k, n = TRACE_CAPTURE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(90)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    held_before = [tuple(shape) for shape, _, _ in captured_graphs()]
    eager = api.matmul(x, w, config=cfg)
    start = len(obs.get_tracer().events())
    obs.enable()
    graphed = backends.get("psram-scheduled", cfg, compiled=True)
    captured = api.matmul(x, w, backend=graphed)
    replayed = api.matmul(x, w, backend=graphed)
    obs.disable()
    capture = {
        "shape": list(TRACE_CAPTURE_SHAPE),
        "captured_before": TRACE_CAPTURE_SHAPE in held_before,
        "captured_under_tracing": TRACE_CAPTURE_SHAPE in
        [tuple(shape) for shape, _, _ in captured_graphs()],
        "bit_equal_to_eager": bool(torch.equal(captured, eager)),
        "replay_bit_equal_to_eager": bool(torch.equal(replayed, eager)),
        "spans": [e["name"] for e in obs.get_tracer().events()[start:]],
    }
    del x, w, eager, captured, replayed, graphed
    clear_program_cache()
    step_s["capture"], t0 = time.perf_counter() - t0, time.perf_counter()

    # the drift auditor, traced (its obs/drift/report span lands in the trace)
    obs.enable()
    drift = obs.drift_report()
    obs.disable()
    step_s["drift"], t0 = time.perf_counter() - t0, time.perf_counter()

    # the mesh timeline of mode 0's fiber lengths against the planned programs
    fibers = csfs[0].fiber_lengths()
    mesh_events = obs.mesh_timeline(fibers, RANK, config=cfg, n_arrays=MESH_ARRAYS,
                                    max_events=MESH_EVENTS)
    planned = [count_cycles(p).total_cycles for p in
               partition_fiber_lengths(fibers, MESH_ARRAYS, RANK, cfg, planner="makespan").programs]
    arrays = {e["pid"]: int(e["args"]["name"][5:7]) for e in mesh_events
              if e["name"] == "process_name" and e["args"]["name"].startswith("array")}
    ends = [0.0] * MESH_ARRAYS
    for e in mesh_events:
        if e["ph"] == "X" and e["pid"] in arrays:
            ends[arrays[e["pid"]]] = max(ends[arrays[e["pid"]]], e["ts"] + e["dur"])
    (allreduce,) = [e for e in mesh_events if e["name"] == "allreduce"]
    timeline = {
        "arrays": MESH_ARRAYS, "max_events": MESH_EVENTS, "events": len(mesh_events),
        "array_end_cycles": ends, "planned_cycles": planned,
        "allreduce_ts": allreduce["ts"], "allreduce_cycles": allreduce["args"]["reduce_cycles"],
    }
    obs.get_tracer().add_events(mesh_events)
    step_s["mesh_timeline"], t0 = time.perf_counter() - t0, time.perf_counter()

    # the trace file, written and read back
    counters = obs.get_tracer().counters()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        n_events = obs.write_trace(str(path))
        trace_bytes = path.stat().st_size
        trace = json.loads(path.read_text())
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X" and e["pid"] == 0]
    virtual = [e for e in trace["traceEvents"] if e["ph"] == "X" and e["pid"] != 0]
    samples = {e["name"]: e["args"]["value"] for e in trace["traceEvents"] if e["ph"] == "C"}
    stream_nnz = sum(e["args"]["nnz"] for e in xs if e["name"] == "stream/mttkrp/execute")
    trace_file = {
        "events": n_events, "bytes": trace_bytes, "loaded_events": len(trace["traceEvents"]),
        "wall_events": len(xs), "virtual_events": len(virtual),
        "cat_is_first_segment": all(e["cat"] == e["name"].split("/", 1)[0] for e in xs)
        and all(e["cat"] == "virtual" for e in virtual),
        "counters": samples, "stream_mttkrp_nnz_sum": stream_nnz,
        "producer": trace["otherData"]["producer"],
    }
    obs.get_tracer().clear()
    step_s["trace_file"], t0 = time.perf_counter() - t0, time.perf_counter()

    # the overhead: warm hopper sweeps untraced (each from its start to the
    # next one's) and traced (sweep + fit spans)
    untraced = sweep_ms("hopper", sweeps=OVERHEAD_SWEEPS)
    obs.enable()
    run("hopper", {}, n_iter=OVERHEAD_SWEEPS)
    obs.disable()
    traced_ms = [sp["sweep_ms"] + sp["fit_ms"]
                 for sp in sweep_splits(obs.get_tracer().events(), "hopper")]
    obs.get_tracer().clear()
    step_s["overhead"] = time.perf_counter() - t0
    overhead = {"sweeps": OVERHEAD_SWEEPS, "untraced_ms": untraced, "traced_ms": traced_ms,
                "untraced_median_ms": statistics.median(untraced),
                "traced_median_ms": statistics.median(traced_ms)}

    phase = {
        "phase": "main_path_trace", "runs": runs, "launches": launches,
        "stopwatch": stopwatch_cases, "stopwatch_discarded": stopwatch_discarded,
        "capture": capture,
        "drift": {"rows": len(drift.rows), "max_drift": drift.max_drift},
        "mesh_timeline": timeline, "trace_file": trace_file, "overhead": overhead,
        "step_s": step_s,
    }
    faults = [key for key, r in runs.items() if not r["bit_equal_to_untraced"]]
    if faults:
        raise AssertionError(f"traced runs differ from untraced ones: {faults}: {phase}")
    if not all(c["within"] for c in stopwatch_cases):
        raise AssertionError(f"the stopwatch strays from the CUDA events: {phase}")
    if capture["captured_before"] or not (capture["captured_under_tracing"]
                                          and capture["bit_equal_to_eager"]
                                          and capture["replay_bit_equal_to_eager"]):
        raise AssertionError(f"the capture under tracing: {phase}")
    if drift.max_drift != 0.0:
        raise AssertionError(f"the drift report is not 0: {phase}")
    if len(mesh_events) > MESH_EVENTS or ends != [float(c) for c in planned] \
            or allreduce["ts"] != max(planned):
        raise AssertionError(f"the mesh timeline: {phase}")
    if not (trace_file["cat_is_first_segment"] and trace_file["loaded_events"] == n_events
            and samples.get("stream/nonzeros") == stream_nnz == counters["stream/nonzeros"]):
        raise AssertionError(f"the trace file: {phase}")
    if obs.enabled() or obs.get_tracer().events():
        raise AssertionError("the tracer is left enabled or holding events")
    return phase


def stamped_sweeps(torch, cp_als, backend_cls, cfg, coo, csfs, init, sweeps, **kwargs):
    """``cp_als`` of ``sweeps`` sweeps on an instance of ``backend_cls``
    that stamps the clock (after a synchronize) whenever mode 0 is asked
    for, and once more after the run: ``(state, per_sweep_ms)``, sweep i
    running from its stamp to the next (its fit included)."""
    stamps = []

    class Stamped(backend_cls):
        def mttkrp(self, data, factors, mode):
            if mode == 0:
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
            return super().mttkrp(data, factors, mode)

    state = cp_als(None, RANK, n_iter=sweeps, sparse=coo, backend=Stamped(cfg, **kwargs),
                   csfs=csfs, init=init, tol=0)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    return state, [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]


def main_path_autotune(torch, cfg, coo, csfs, init, zero_counts, read_counts) -> tuple:
    """The ``main_path_autotune`` phase: ``cp_als`` (rank 32, ``TUNE_SWEEPS``
    sweeps) on ``backends.get("hopper", autotune=True)`` under tracing, from
    an empty winner cache: every sweep of ``kernels.autotune`` with each
    trial's ``exec_blocks``, kernel 1 route and median ms, and its winner;
    then a second call a mode under tracing (no ``autotune/trials``), each
    tuned MTTKRP against ``exact`` and bit-equal to the untuned op forced to
    the winner's ``exec_blocks``, and the winner table through
    ``save_cache`` → ``clear_autotune_cache`` → ``load_cache`` (the same
    winners, no sweep). The counts are zeroed before the ``cp_als`` run and
    read after it: ``(phase, launches)``. Ends with an untuned call a mode,
    so the layouts cached on the CSFs are the heuristic's again."""
    from repro_torch import api, backends, obs
    from repro_torch.core.cp_als import cp_als
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ops import fused_stream_mttkrp_op

    autotune.clear_autotune_cache()
    tuned_be = backends.get("hopper", cfg, autotune=True)
    obs.get_tracer().clear()
    obs.enable()
    zero_counts()
    t0 = time.perf_counter()
    try:
        state = cp_als(None, RANK, n_iter=TUNE_SWEEPS, sparse=coo, backend=tuned_be,
                       csfs=csfs, init=init, tol=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts()
        first_trials = obs.get_tracer().counters().get("autotune/trials", 0)
        obs.get_tracer().clear()
        fs = tuple(state.factors)
        again = [tuned_be.mttkrp(csfs[m], fs, m) for m in range(3)]
        second_trials = obs.get_tracer().counters().get("autotune/trials", 0)
    finally:
        obs.disable()
        obs.get_tracer().clear()
    sweeps = [{"shape": list(s["key"].shape), "profile": list(s["key"].profile),
               "trials": [{"exec_blocks": t["params"]["exec_blocks"], "route": t["route"],
                           "median_ms": 1e3 * t["median_s"]} for t in s["trials"]],
               "winner": s["winner"]["exec_blocks"]} for s in autotune.sweep_log()]
    winners = [autotune.stream_params(csfs[m], fs, cfg)["exec_blocks"] for m in range(3)]
    rel, bit_equal = [], []
    for m in range(3):
        want = api.mttkrp(csfs[m], fs, m, backend="exact")
        rel.append(float(torch.linalg.norm(again[m] - want) / torch.linalg.norm(want)))
        forced = fused_stream_mttkrp_op(csfs[m], fs, cfg, exec_blocks=winners[m])
        bit_equal.append(bool(torch.equal(again[m], forced)))
        del want, forced
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "winners.json")
        saved = autotune.save_cache(path)
        autotune.clear_autotune_cache()
        loaded = autotune.load_cache(path)
    reloaded = [autotune.stream_params(csfs[m], fs, cfg, tune=True)["exec_blocks"]
                for m in range(3)]
    reload_sweeps = len(autotune.sweep_log())
    autotune.clear_autotune_cache()
    untuned_rel = []
    for m in range(3):       # the heuristic's layouts back on the CSFs
        untuned = fused_stream_mttkrp_op(csfs[m], fs, cfg)
        untuned_rel.append(float(torch.linalg.norm(again[m] - untuned)
                                 / torch.linalg.norm(untuned)))
    torch.cuda.synchronize()
    rel_tol = tuned_be.capabilities().rel_tol
    phase = {
        "phase": "main_path_autotune", "sweeps_run": TUNE_SWEEPS, "rank": RANK,
        "fit": state.fit, "iters": state.iters, "cp_als_s": run_s, "launches": launches,
        "autotune_sweeps": sweeps, "winners": winners,
        "trials_first_run": first_trials, "trials_second_call": second_trials,
        "rel_err": rel, "rel_tol": rel_tol, "bit_equal_to_forced_winner": bit_equal,
        "rel_to_untuned": untuned_rel,
        "saved": saved, "loaded": loaded, "reloaded_winners": reloaded,
        "reload_sweeps": reload_sweeps,
    }
    n_trials = sum(len(s["trials"]) for s in sweeps)
    if not math.isfinite(state.fit) or state.iters != TUNE_SWEEPS:
        raise AssertionError(f"tuned CP-ALS: {phase}")
    if not sweeps or first_trials != n_trials or second_trials != 0:
        raise AssertionError(f"the tuned run swept nothing, or a second call swept again: "
                             f"{phase}")
    if not all(bit_equal) or not max(rel) < rel_tol:
        raise AssertionError(f"a tuned MTTKRP is not the untuned call at its winner, or "
                             f"strays from exact: {phase}")
    if reloaded != winners or reload_sweeps != 0 or loaded != saved:
        raise AssertionError(f"the winner table did not round-trip: {phase}")
    # each trial: a warm-up call and 3 timed ones; each mode of each sweep one call
    if launches["stream_mttkrp_fused"] != 4 * n_trials + 3 * TUNE_SWEEPS:
        raise AssertionError(f"the tuned run's kernel 1 launches: {phase}")
    return phase, launches


def main_path_mesh(torch, cfg, coo, csfs, init, zero_counts, read_counts, psram_fit) -> tuple:
    """The ``main_path_mesh`` phase: the ``psram-mesh`` backend at
    ``MESH_MAIN_ARRAYS`` arrays looped on one card. With the counts zeroed
    before and read after: each lowering of ``mesh_stream_mttkrp`` once a
    mode, and ``cp_als`` (rank 32, 3 sweeps) on ``psram-mesh`` (eager),
    stamped a sweep. Then, for each mode: the eager result bit-equal to the
    single-device ``psram-stream`` eager call, ``"compiled"`` and
    ``"fused"`` within ``rel_tol`` of exact, each lowering's call ms beside
    its single-device call's, each shard's nnz and the planner's imbalance,
    and the counted 4-array price (``"psram-mesh"``'s ``cost``) equal to
    ``"analytical"``'s field for field, the array's time beside the card's;
    the split Gram against ``f.T @ f``; the ``mesh4`` drift row; the
    per-array tracks of mode 0's executed plan. ``(phase, launches)``."""
    from repro_torch import api, backends, obs
    from repro_torch.core.cp_als import cp_als
    from repro_torch.core.perf_model import MeshSparseMTTKRPWorkload, mesh_sparse_price
    from repro_torch.kernels.ops import fused_stream_mttkrp_op
    from repro_torch.sparse.mesh import (MESH_LOWERINGS, _mesh_partition, mesh_counted_price,
                                         mesh_gram, mesh_plan_timeline, mesh_stream_mttkrp)
    from repro_torch.sparse.stream import stream_mttkrp

    n = MESH_MAIN_ARRAYS
    fs = tuple(init)
    kernel_keys = ("stream_mttkrp_fused", "blocked_segment_sum_chain_psram",
                   "ordered_fold_chain_psram", "ordered_fold_fold")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    outs, by_lowering = {}, {}
    for low in MESH_LOWERINGS:
        before = read_counts()
        outs[low] = [mesh_stream_mttkrp(csfs[m], fs, cfg, n_arrays=n, lowering=low)
                     for m in range(3)]
        after = read_counts()
        by_lowering[low] = {k: after[k] - before[k] for k in kernel_keys}
    calls_s = time.perf_counter() - t0
    mesh_cls = type(backends.get("psram-mesh", cfg))
    state, per_sweep = stamped_sweeps(torch, cp_als, mesh_cls, cfg, coo, csfs, init, SWEEPS,
                                      n_arrays=n)
    launches = read_counts()
    single = {
        "eager": lambda m: stream_mttkrp(csfs[m], fs, cfg, psram=True),
        "compiled": lambda m: stream_mttkrp(csfs[m], fs, cfg, psram=True, compiled=True),
        "fused": lambda m: fused_stream_mttkrp_op(csfs[m], fs, cfg),
    }
    stream_cls = type(backends.get("psram-stream", cfg))
    stream_state, stream_sweep = stamped_sweeps(torch, cp_als, stream_cls, cfg, coo, csfs,
                                                init, SWEEPS)
    rel_tol = backends.get("psram-mesh", cfg).capabilities().rel_tol
    modes = []
    for m in range(3):
        want = api.mttkrp(csfs[m], fs, m, backend="exact")
        norm = torch.linalg.norm(want)
        meshed = _mesh_partition(csfs[m], n, RANK, cfg, "makespan")
        row = {
            "mode": m, "shard_nnz": [s.nnz for s in meshed.shards],
            "imbalance": meshed.imbalance,
            "eager_bit_equal_to_single": bool(torch.equal(outs["eager"][m], single["eager"](m))),
            "rel_err": {low: float(torch.linalg.norm(outs[low][m] - want) / norm)
                        for low in MESH_LOWERINGS},
            "ms": {low: time_ms(torch, lambda low=low: mesh_stream_mttkrp(
                       csfs[m], fs, cfg, n_arrays=n, lowering=low), warmup=1, iters=3, reps=2)
                   for low in MESH_LOWERINGS},
            "single_ms": {low: time_ms(torch, lambda low=low: single[low](m), warmup=1,
                                       iters=3, reps=2) for low in MESH_LOWERINGS},
        }
        wl = MeshSparseMTTKRPWorkload(fiber_lengths=csfs[m].fiber_lengths(), rank=RANK,
                                      n_arrays=n)
        counted = backends.get("psram-mesh", cfg).cost(wl)
        ana = backends.get("analytical", cfg).cost(wl)
        c_price, _ = mesh_counted_price(wl.fiber_lengths, RANK, cfg, n_arrays=n,
                                        out_rows=wl.reduced_rows)
        a_price = mesh_sparse_price(cfg, wl)
        row["price"] = {
            "counted_time_s": counted.time_s, "analytical_time_s": ana.time_s,
            "equal": counted.time_s == ana.time_s and counted.counts == ana.counts
            and dataclasses.asdict(counted.breakdown) == dataclasses.asdict(ana.breakdown)
            and c_price.per_array == a_price.per_array
            and c_price.reduce_cycles == a_price.reduce_cycles
            and c_price.makespan_cycles == a_price.makespan_cycles,
            "makespan_cycles": c_price.makespan_cycles,
            "reduce_cycles": c_price.reduce_cycles,
            "per_array_cycles": [c.total_cycles for c in c_price.per_array],
            "array_ms": 1e3 * counted.time_s, "card_eager_ms": row["ms"]["eager"],
        }
        modes.append(row)
        del want
    gram = [float((mesh_gram(f, n_arrays=n) - f.T @ f).abs().max() / (f.T @ f).abs().max())
            for f in state.factors]
    drift = [r for r in obs.drift_report().rows if r.workload == "mttkrp/sparse/mesh4"]
    events = mesh_plan_timeline(csfs[0], RANK, cfg, n_arrays=n, max_events=MESH_EVENTS)
    (allreduce,) = [e for e in events if e["name"] == "allreduce"]
    phase = {
        "phase": "main_path_mesh", "n_arrays": n, "rank": RANK, "sweeps": SWEEPS,
        "calls_s": calls_s, "launches": launches, "launches_by_lowering": by_lowering,
        "modes": modes,
        "fit": state.fit, "fit_psram_stream": stream_state.fit,
        "fit_psram_stream_main_path": psram_fit, "iters": state.iters,
        "per_sweep_ms": per_sweep, "per_sweep_ms_psram_stream": stream_sweep,
        "gram_max_rel_err": gram, "rel_tol": rel_tol,
        "drift_mesh4": [r.to_dict() for r in drift],
        "timeline": {"events": len(events), "allreduce_ts": allreduce["ts"],
                     "makespan_cycles": _mesh_partition(csfs[0], n, RANK, cfg,
                                                        "makespan").critical_path_cycles},
    }
    if not all(r["eager_bit_equal_to_single"] for r in modes):
        raise AssertionError(f"the eager mesh is not the single-device stream: {phase}")
    if not max(max(r["rel_err"].values()) for r in modes) < rel_tol:
        raise AssertionError(f"a mesh lowering strays from exact beyond rel_tol: {phase}")
    if not all(r["price"]["equal"] for r in modes):
        raise AssertionError(f"the counted 4-array price is not the analytical one: {phase}")
    if not (math.isfinite(state.fit) and abs(state.fit - stream_state.fit) < 1e-3
            and state.iters == SWEEPS) or max(gram) > 1e-5:
        raise AssertionError(f"psram-mesh CP-ALS or its Gram strays: {phase}")
    if len(drift) != 1 or drift[0].drift != 0.0 \
            or allreduce["ts"] != phase["timeline"]["makespan_cycles"]:
        raise AssertionError(f"the mesh4 drift row or the executed plan's timeline: {phase}")
    shards = sum(sum(1 for s in r["shard_nnz"] if s) for r in modes)
    # eager: a quantized ordered-fold chain launch a shard (the calls, then
    # the CP-ALS modes, each exact fit one exact chain launch); compiled: a
    # quantized kernel 5 launch and a fold launch a shard; fused: kernel 1
    # once a shard
    want = {"eager": (0, 0, shards, 0), "compiled": (0, shards, 0, shards),
            "fused": (shards, 0, 0, 0)}
    if any(tuple(by_lowering[low][k] for k in kernel_keys) != want[low] for low in want) \
            or launches["ordered_fold_chain_psram"] != shards * (1 + SWEEPS) \
            or launches["ordered_fold_chain"] != SWEEPS:
        raise AssertionError(f"the mesh lowerings did not launch their kernels once a "
                             f"shard: {phase}")
    return phase, launches


# ------------------------------------------------------ faults and the MoE family


def main_path_faults(torch, cfg, csfs, init, zero_counts, read_counts) -> tuple:
    """The ``main_path_faults`` phase: ``repro_torch.faults`` on the card,
    with the counts zeroed before and read after.

    (a) ``abft_matmul`` at ``MLP_SHAPE`` on ``psram-scheduled``: clean, no
    site and ``y`` bit-equal to ``execute``; then a stuck-MSB plan under
    which the detector flags tens of the 448 N-tiles: each recovered or
    taken by the fallback, the relative L2 error against the clean run
    within ``rel_tol`` (the max-abs ratio and the tiles still differing
    reported beside it: the L1/L2-scaled thresholds let small faults
    through), recovery priced; the call's ms and the host seconds of its
    mask draw. (b) The reference test's plan at 8 x 64 x 96 on the card and
    on the CPU: the reports equal field for field, ``y`` bit-equal. (c)
    ``abft_mttkrp`` on mode 1 of the sparse tensor, 4 arrays, eager, one
    root fiber a group: clean, nothing detected and ``y`` bit-equal to the
    mesh call; then transient spikes: what the detector saw, the relative
    L2 error against the clean run within ``rel_tol``, and the rows still
    differing (undetected spikes) beside it. (d) ``degraded_mesh_mttkrp`` at 4 arrays with
    array 1 lost: ``y`` bit-equal to the clean 4-array mesh, the capacity
    it keeps, the recovery cycles and the ordered fold's launches.
    ``(phase, launches)``."""
    from repro_torch import faults
    from repro_torch.core.schedule import _FaultSites, build_matmul_program, execute
    from repro_torch.sparse.mesh import mesh_stream_mttkrp

    n_arrays = MESH_MAIN_ARRAYS
    m, k, n = MLP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    prog = build_matmul_program(m, k, n, cfg)
    plan_a = faults.FaultPlan(seed=7, stuck_bits=(faults.StuckBit(rate=FAULT_STUCK_RATE),))
    kt, nt, mt = -(-k // cfg.rows), -(-n // cfg.word_cols), -(-m // cfg.wavelengths)
    torch.cuda.synchronize()
    zero_counts()

    # (a) the scheduled matmul at full size
    y_clean, rep_clean = faults.abft_matmul(x, w, cfg)
    plain = execute(prog, x, w)
    t0 = time.perf_counter()
    with faults.inject(plan_a):
        _FaultSites(plan_a, rows=cfg.rows, cols=cfg.word_cols, wav=cfg.wavelengths, kt=kt,
                    nt=nt, mt=mt, device=x.device)
    mask_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with faults.inject(plan_a):
        y_a, rep_a = faults.abft_matmul(x, w, cfg)
    torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0)
    err_a = float(torch.linalg.norm(y_a - y_clean) / torch.linalg.norm(y_clean))
    tiles_differing = int(((y_a - y_clean).abs().amax(dim=0) > 0).reshape(-1, cfg.word_cols)
                          .any(dim=1).sum())
    matmul = {
        "shape": list(MLP_SHAPE), "n_tiles": rep_clean.checked,
        "clean_detected": rep_clean.detected,
        "clean_bit_equal_to_execute": bool(torch.equal(y_clean, plain)),
        "stuck_rate": FAULT_STUCK_RATE, "stored_words": kt * nt * cfg.rows * cfg.word_cols,
        "detected": len(rep_a.detected), "retries": rep_a.retries,
        "recovered": rep_a.recovered, "fallbacks": rep_a.fallbacks,
        "redrive_cycles": rep_a.redrive_cycles, "backoff_cycles": rep_a.backoff_cycles,
        "checksum_cycles": rep_a.checksum_cycles, "recovery_s": rep_a.recovery_s(cfg),
        "rel_l2_err_vs_clean": err_a, "rel_tol": rep_a.rel_tol,
        "max_abs_err_over_max_abs": float((y_a - y_clean).abs().max() / y_clean.abs().max()),
        "tiles_differing_after": tiles_differing,
        "call_ms": call_ms, "mask_host_s": mask_s,
        "clean_call_ms": time_ms(torch, lambda: faults.abft_matmul(x, w, cfg), warmup=0,
                                 iters=1, reps=1),
    }
    del x, w, y_clean, plain, y_a

    # (b) the card against the CPU at the reference test's shape and plan
    plan_b = faults.FaultPlan(seed=7, stuck_bits=(faults.StuckBit(rate=5e-3),))
    cpu_gen = torch.Generator().manual_seed(0)
    xs = torch.randn((8, 64), generator=cpu_gen)
    ws = torch.randn((64, 96), generator=cpu_gen)
    with faults.inject(plan_b):
        y_cpu, rep_cpu = faults.abft_matmul(xs, ws, cfg)
    with faults.inject(plan_b):
        y_card, rep_card = faults.abft_matmul(xs.cuda(), ws.cuda(), cfg)
    card_vs_cpu = {
        "shape": [8, 64, 96], "detected": rep_card.detected,
        "fallbacks": rep_card.fallbacks, "recovered": rep_card.recovered,
        "reports_equal": dataclasses.asdict(rep_card) == dataclasses.asdict(rep_cpu),
        "y_bit_equal": bool(torch.equal(y_card.cpu(), y_cpu)),
    }

    # (c) the sparse MTTKRP on the 4-array mesh, mode 1
    csf, fs = csfs[1], tuple(init)
    mesh_clean = mesh_stream_mttkrp(csf, fs, cfg, n_arrays=n_arrays)
    t0 = time.perf_counter()
    y_c0, rep_c0 = faults.abft_mttkrp(csf, fs, config=cfg, n_arrays=n_arrays,
                                      group_fibers=FAULT_GROUP_FIBERS)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    plan_c = faults.FaultPlan(seed=7, adc_spikes=(faults.AdcSpike(magnitude=2.0,
                                                                  rate=FAULT_SPIKE_RATE),))
    t0 = time.perf_counter()
    with faults.inject(plan_c):
        y_c, rep_c = faults.abft_mttkrp(csf, fs, config=cfg, n_arrays=n_arrays,
                                        group_fibers=FAULT_GROUP_FIBERS)
    torch.cuda.synchronize()
    spiked_s = time.perf_counter() - t0
    err_c = float(torch.linalg.norm(y_c - mesh_clean) / torch.linalg.norm(mesh_clean))
    differing = torch.nonzero((y_c != mesh_clean).any(dim=1)).flatten().cpu().numpy()
    detected_rows = set(int(r) for g in rep_c.detected
                        for r in csf.fids[0][g * FAULT_GROUP_FIBERS:(g + 1) * FAULT_GROUP_FIBERS])
    mttkrp = {
        "mode": 1, "nnz": csf.nnz, "n_arrays": n_arrays, "group_fibers": FAULT_GROUP_FIBERS,
        "groups": rep_c.checked, "clean_detected": rep_c0.detected,
        "clean_bit_equal_to_mesh": bool(torch.equal(y_c0, mesh_clean)),
        "spike_rate": FAULT_SPIKE_RATE, "detected": len(rep_c.detected),
        "retries": rep_c.retries, "recovered": rep_c.recovered, "fallbacks": rep_c.fallbacks,
        "recovery_cycles": rep_c.recovery_cycles, "rel_l2_err_vs_clean": err_c,
        "max_abs_err_over_max_abs": float((y_c - mesh_clean).abs().max()
                                          / mesh_clean.abs().max()),
        "rows_differing_after": len(differing),
        "rows_differing_in_detected_groups": sum(int(r) in detected_rows for r in differing),
        "rel_tol": rep_c.rel_tol, "clean_call_s": clean_s, "spiked_call_s": spiked_s,
    }
    del y_c0, y_c

    # (d) degraded mode: array 1 of 4 lost on mode 1
    before = read_counts()
    t0 = time.perf_counter()
    y_d, rep_d = faults.degraded_mesh_mttkrp(csf, fs, config=cfg, n_arrays=n_arrays,
                                             dead_arrays=(1,))
    torch.cuda.synchronize()
    degraded_s = time.perf_counter() - t0
    after = read_counts()
    degraded = {
        "dead": list(rep_d.dead), "bit_equal_to_clean_mesh": bool(torch.equal(y_d, mesh_clean)),
        "recovered_rows": rep_d.recovered_rows, "recovery_cycles": rep_d.recovery_cycles,
        "healthy_makespan_cycles": rep_d.healthy_makespan_cycles,
        "degraded_makespan_cycles": rep_d.degraded_makespan_cycles,
        "throughput_frac": rep_d.throughput_frac, "call_s": degraded_s,
        "chain_psram_launches": after["ordered_fold_chain_psram"]
        - before["ordered_fold_chain_psram"],
    }
    del y_d, mesh_clean
    launches = read_counts()
    phase = {"phase": "main_path_faults", "matmul": matmul, "card_vs_cpu": card_vs_cpu,
             "mttkrp": mttkrp, "degraded": degraded, "launches": launches}
    if rep_clean.detected or not matmul["clean_bit_equal_to_execute"]:
        raise AssertionError(f"ABFT flagged the clean scheduled matmul: {phase}")
    if not (0 < matmul["detected"] < rep_clean.checked
            and rep_a.recovered + rep_a.fallbacks == matmul["detected"]
            and err_a <= rep_a.rel_tol and rep_a.recovery_cycles > 0):
        raise AssertionError(f"ABFT on the faulty scheduled matmul: {phase}")
    if not (card_vs_cpu["reports_equal"] and card_vs_cpu["y_bit_equal"]
            and rep_card.detected):
        raise AssertionError(f"ABFT on the card differs from the CPU: {phase}")
    if rep_c0.detected or not mttkrp["clean_bit_equal_to_mesh"]:
        raise AssertionError(f"ABFT flagged the clean mesh MTTKRP: {phase}")
    if not (mttkrp["detected"] and rep_c.recovered + rep_c.fallbacks == mttkrp["detected"]
            and err_c <= rep_c.rel_tol):
        raise AssertionError(f"ABFT on the spiked mesh MTTKRP: {phase}")
    shards = sum(1 for s in range(n_arrays) if s != 1)
    if not (degraded["bit_equal_to_clean_mesh"] and 0 < rep_d.throughput_frac <= 1
            and degraded["chain_psram_launches"] == shards + 1):
        raise AssertionError(f"degraded mode is not the clean mesh: {phase}")
    # the mesh stream and every re-drive on the quantized chain route; the
    # group checksums on the fold route, two a checked MTTKRP
    if launches["ordered_fold_chain_psram"] < 2 * n_arrays + mttkrp["retries"] \
            or launches["ordered_fold_fold"] != 4:
        raise AssertionError(f"the fault paths did not launch the ordered fold: {phase}")
    return phase, launches


def moe_drop_share(torch, eng, params, prompts) -> dict:
    """The share of token-to-expert assignments that the capacity drops, in
    one prefill and in the decode step after it, over every MoE layer (each
    call of ``models.moe.route`` recorded)."""
    import repro_torch.models.moe as moe_mod

    route = moe_mod.route
    seen = []

    def record(*args, **kwargs):
        out = route(*args, **kwargs)
        seen.append(out[3])
        return out

    moe_mod.route = record
    try:
        with torch.inference_mode():
            logits, cache = eng.prefill_fn(params, prompts)
            prefill, seen = seen, []
            eng.step_fn(params, cache, logits.argmax(-1).to(torch.int32), prompts.shape[1])
            step = seen
    finally:
        moe_mod.route = route
    del logits, cache

    def share(keeps):
        return 1.0 - float(sum(int(kp.sum()) for kp in keeps)) / sum(kp.numel() for kp in keeps)

    return {"prefill": share(prefill), "decode_step": share(step),
            "prefill_assignments_per_layer": prefill[0].numel(),
            "decode_assignments_per_layer": step[0].numel(), "layers": len(prefill)}


def served_einsum_cases(torch, eng, params, prompts) -> list:
    """``psram_einsum`` held BIT-EQUAL to kernel 2 run on each expert, on the
    operands layer 0's three expert products (wi, wg, wo) take in one served
    prefill: its dispatch buffer ``(E, C, d)`` and the hidden buffer
    ``(E, C, ff)``. The module-level ``psram_einsum`` is wrapped for this
    one prefill; the kernel-2 launches here are not counted on the main
    path."""
    import repro_torch.core.photonic_layer as photonic
    from repro_torch.core.quantization import quantize_symmetric
    from repro_torch.kernels.psram_matmul import psram_matmul

    einsum = photonic.psram_einsum
    seen = []

    def record(spec, x, w, adc_bits=16):
        out = einsum(spec, x, w, adc_bits)
        if len(seen) < 3:
            seen.append((spec, x, w, adc_bits, out))
        return out

    photonic.psram_einsum = record
    try:
        with torch.inference_mode():
            eng.prefill_fn(params, prompts)
    finally:
        photonic.psram_einsum = einsum
    cases = []
    for spec, x, w, adc_bits, got in seen:
        qx, sx = quantize_symmetric(x, axis=-1)
        differ = 0
        for e in range(x.shape[0]):
            want = psram_matmul(qx[e], w["q"][e].contiguous(), sx[e].to(torch.float32),
                                w["scale"][0].contiguous(), adc_bits=adc_bits)
            differ += int(not torch.equal(got[e], want))
        cases.append({"spec": spec, "x_shape": list(x.shape), "w_shape": list(w["q"].shape),
                      "experts": x.shape[0], "experts_differing": differ,
                      "ms": time_ms(torch, lambda: einsum(spec, x, w, adc_bits), warmup=1,
                                    iters=3, reps=2),
                      "kernel2_ms": time_ms(torch, lambda: [psram_matmul(
                          qx[e], w["q"][e].contiguous(), sx[e].to(torch.float32),
                          w["scale"][0].contiguous(), adc_bits=adc_bits)
                          for e in range(x.shape[0])], warmup=1, iters=3, reps=2),
                      "bound_ms": einsum_bound_ms(x, w)})
    if len(cases) != 3 or any(c["experts_differing"] for c in cases):
        raise AssertionError(f"psram_einsum differs from kernel 2 on the served experts: "
                             f"{cases}")
    return cases


def einsum_bound_ms(x, w) -> float:
    """The least time for one ``psram_einsum``: its int8 products at the int8
    peak against its bytes (x in its dtype, the int8 words, the scales, the
    f32 output, each once)."""
    e, c, k = x.shape
    n = w["q"].shape[-1]
    ops = 2.0 * e * c * k * n
    moved = x.numel() * x.element_size() + w["q"].numel() + 4 * n + 4 * e * c * n
    return 1e3 * max(moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)


def main_path_moe(torch, zero_counts, read_counts) -> tuple:
    """The ``main_path_moe`` phase: granite-moe-1b-a400m at full width and
    depth (24 layers, 32 experts top-8, bf16, random weights from a seed)
    served as ``main_path_serve`` serves granite-8b: 8 prompts x 1024
    tokens, 64 greedy tokens, exact and then with ``psram_projections`` and
    ``psram_stored_int8`` (attention projections through kernel 2, experts
    through ``psram_einsum``), each ``generate`` with the counts zeroed
    before and read after. Reports prefill ms, decode ms a step, tokens/s,
    launches a decode step, the dropped share of assignments; checks the
    pSRAM prefill against an exact prefill on the dequantized words (< 0.5),
    the first decode step against ``forward`` on a dropless replica
    (relative L2 <= 0.05), and ``psram_einsum`` bit-equal to kernel 2 on
    layer 0's served buffers. ``(phase, exact launches, pSRAM launches)``."""
    from repro_torch.models import get_config, transformer
    from repro_torch.models.moe import capacity
    from repro_torch.serve import ServeEngine

    cfg = get_config(MOE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(13, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = seeded_prompts(torch, cfg, SERVE_BATCH, SERVE_PROMPT, 14)
    exact_run, exact_launches, _, eng, _ = serve_run(
        torch, cfg, params, prompts, ServeEngine, zero_counts, read_counts)
    exact_run["drop_share"] = moe_drop_share(torch, eng, params, prompts)
    exact_run["decode_vs_forward_rel_l2_with_drops"] = exact_run.pop("decode_vs_forward_rel_l2")
    exact_peak = torch.cuda.max_memory_allocated()

    # the first decode step against forward on a dropless replica (the same
    # weights, capacity C = T): with drops the two legitimately differ
    dropless = dataclasses.replace(cfg, moe_capacity_factor=None)
    with torch.inference_mode():
        logits, cache = transformer.prefill(params, prompts, dropless, SERVE_PROMPT + 1)
        tok = logits.argmax(-1).to(torch.int32)
        first, _ = transformer.decode_step(params, cache, tok, SERVE_PROMPT, dropless)
        full = transformer.forward(params, torch.cat([prompts, tok[:, None]], dim=1),
                                   dropless)[:, -1]
        dropless_rel = float(torch.linalg.norm(first.float() - full)
                             / torch.linalg.norm(full))
        del logits, cache, first, full
    del eng, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    pcfg = dataclasses.replace(cfg, psram_projections=True, psram_stored_int8=True)
    pparams = transformer.init(15, pcfg, device="cuda")
    int8_bytes = int8_word_bytes(pparams)
    psram_run, psram_launches, psram_logits, peng, _ = serve_run(
        torch, pcfg, pparams, prompts, ServeEngine, zero_counts, read_counts)
    psram_run["drop_share"] = moe_drop_share(torch, peng, pparams, prompts)
    psram_run["decode_vs_forward_rel_l2_with_drops"] = psram_run.pop("decode_vs_forward_rel_l2")
    einsum_cases = served_einsum_cases(torch, peng, pparams, prompts)
    del peng
    # an exact model whose weights are the array's words dequantized
    psram_vs_deq = psram_vs_dequantized(torch, transformer, pparams, (), prompts, cfg,
                                        psram_logits)
    psram_peak = torch.cuda.max_memory_allocated()
    del pparams, psram_logits
    torch.cuda.empty_cache()
    n_attn = 4 * cfg.num_layers                       # kernel 2 a forward: q, k, v, o
    phase = {
        "phase": "main_path_moe", "arch": MOE_ARCH, "layers": cfg.num_layers,
        "experts": cfg.num_experts, "top_k": cfg.top_k, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(), "dtype": cfg.dtype, "init_s": init_s,
        "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT, "max_new": SERVE_NEW,
        "capacity": {"prefill": capacity(SERVE_BATCH * SERVE_PROMPT, cfg),
                     "decode_step": capacity(SERVE_BATCH, cfg)},
        "exact": {**exact_run, "launches": exact_launches, "device_bytes_peak": exact_peak,
                  "decode_vs_forward_rel_l2_dropless": dropless_rel},
        "psram": {**psram_run, "launches": psram_launches, "int8_weight_bytes": int8_bytes,
                  "prefill_vs_dequantized_rel_l2": psram_vs_deq,
                  "layer0_einsum_vs_kernel2": einsum_cases, "device_bytes_peak": psram_peak},
    }
    # kernel 2 on every attention projection: the wgmma route in the
    # prefill, the decode route in a step. With drops a step and forward
    # legitimately differ: the dropless replica's is gated instead
    check_served("the MoE model", phase,
                 {"wgmma": n_attn, "tile": 0, "decode": n_attn * SERVE_NEW}, decode_gated=())
    if not dropless_rel <= 0.05:
        raise AssertionError(f"the MoE decode strays from forward (dropless): {phase}")
    return phase, exact_launches, psram_launches


def dequantized(tree, dtype):
    """``tree`` with every ``{"q", "scale"}`` of stored array words replaced by
    the words dequantized (``q * scale``, rounded to ``dtype``): the exact
    model the pSRAM one approximates."""
    from repro_torch.models.layers import is_quantized

    if is_quantized(tree):
        return (tree["q"].float() * tree["scale"]).to(dtype)
    if isinstance(tree, dict):
        return {k: dequantized(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequantized(v, dtype) for v in tree]
    return tree


def int8_word_bytes(tree) -> int:
    """Bytes of the stored int8 array words in a param tree."""
    from repro_torch.models.layers import is_quantized

    if is_quantized(tree):
        return tree["q"].numel()
    if isinstance(tree, dict):
        return sum(int8_word_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(int8_word_bytes(v) for v in tree)
    return 0


def seeded_prompts(torch, cfg, batch, length, seed):
    return torch.randint(2, cfg.vocab_size, (batch, length), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(seed))


def psram_vs_dequantized(torch, mod, pparams, lead, prompts, cfg, psram_logits) -> float:
    """Relative L2 of the pSRAM prefill's logits against an exact prefill
    of the same prompts on the dequantized words (catches garbage)."""
    from repro_torch.models.layers import as_dtype

    dparams = dequantized(pparams, as_dtype(cfg.dtype))
    with torch.inference_mode():
        deq_logits, _ = mod.prefill(dparams, *lead, prompts, cfg, prompts.shape[1])
    rel = float(torch.linalg.norm(psram_logits - deq_logits) / torch.linalg.norm(deq_logits))
    del dparams, deq_logits
    return rel


def check_served(name, phase, want_psram=None, decode_gated=("exact", "psram"),
                 dequantized_gated=True):
    """What "served correctly" means, for every served model's phase: each
    run's tokens finite, in the vocabulary and ``batch`` x ``max_new``; no
    kernel-2 launch in the exact run, and in the pSRAM one (if the phase
    has one) exactly ``want_psram`` (route -> launches); the first decode
    step within 0.05 of ``forward`` (relative L2) for the runs named in
    ``decode_gated``; and, if ``dequantized_gated``, the pSRAM prefill
    within 0.5 of an exact prefill on the dequantized words."""
    runs = {label: phase[label] for label in ("exact", "psram") if label in phase}
    for label, run in runs.items():
        if not (run["finite"] and run["tokens_in_vocab"]
                and run["tokens_shape"] == [phase["batch"], phase["max_new"]]):
            raise AssertionError(f"serving {name} ({label}) gave no finite in-vocab tokens: "
                                 f"{phase}")
        if label in decode_gated and not run["decode_vs_forward_rel_l2"] <= 0.05:
            raise AssertionError(f"{name}'s decode strays from forward ({label}): {phase}")
    if runs["exact"]["launches"]["psram_matmul"] != 0:
        raise AssertionError(f"the exact {name} launched kernel 2: {phase}")
    if "psram" not in runs:
        return
    rel = runs["psram"]["prefill_vs_dequantized_rel_l2"]
    if dequantized_gated and not (math.isfinite(rel) and rel < 0.5):
        raise AssertionError(f"{name}'s pSRAM prefill logits are garbage: {phase}")
    launches = runs["psram"]["launches"]
    got = {route: launches[f"psram_matmul_{route}"] for route in want_psram}
    if got != want_psram or launches["psram_matmul"] != sum(want_psram.values()):
        raise AssertionError(f"the pSRAM {name} did not launch kernel 2 as its projections "
                             f"ask ({want_psram}, got {got}): {phase}")


def ssd_ops(b, s, h, p, n, q) -> float:
    """f32 operations of one ``ssd_chunked``: its four contractions (C·B,
    the diagonal blocks, the chunk states, the state outputs; 2 a
    multiply-add), the (B, nc, H, q, q) weights (exp and two products) and
    the chunk recurrence."""
    nc = -(-s // q)
    sp = nc * q
    return (2.0 * b * sp * q * n + 3.0 * b * nc * h * q * q + 2.0 * b * nc * h * q * q * p
            + 2.0 * b * sp * h * p * n * 2 + 2.0 * b * nc * h * p * n)


def ssd_case(torch, cfg, seed=31) -> dict:
    """``ssd_chunked`` at one layer's served shape (B 8, S 1024, H 32, P 64,
    N 128, chunks of 128) on the card against the same inputs on the CPU,
    within ``SSD_TOL`` of max |y| (a TF32 product or a misplaced reduction
    would show), timed beside its bound (f32 operations at the f32 peak
    against the bytes: the inputs, y and the final state once)."""
    from repro_torch.models.ssm import ssd_chunked

    b, s, h, p, n = SERVE_BATCH, SERVE_PROMPT, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device="cuda"))
    a = -torch.exp(0.3 * torch.randn((h,), generator=g, device="cuda"))
    bm = torch.randn((b, s, n), generator=g, device="cuda")
    cm = torch.randn((b, s, n), generator=g, device="cuda")
    y, st = ssd_chunked(x, dt, a, bm, cm, cfg.ssm_chunk)
    t0 = time.perf_counter()
    yc, stc = ssd_chunked(*(t.cpu() for t in (x, dt, a, bm, cm)), cfg.ssm_chunk)
    cpu_s = time.perf_counter() - t0
    err_y = float((y.cpu() - yc).abs().max()) / float(yc.abs().max())
    err_s = float((st.cpu() - stc).abs().max()) / float(stc.abs().max())
    ms = time_ms(torch, lambda: ssd_chunked(x, dt, a, bm, cm, cfg.ssm_chunk))
    ops = ssd_ops(b, s, h, p, n, cfg.ssm_chunk)
    moved = nbytes(x, dt, a, bm, cm, y, st)
    bound = {"operations": 1e3 * ops / F32_FLOPS_PER_S, "bytes": 1e3 * moved / HBM_BYTES_PER_S}
    case = {"shape": {"B": b, "S": s, "H": h, "P": p, "N": n, "chunk": cfg.ssm_chunk},
            "rel_err_y": err_y, "rel_err_state": err_s, "tolerance": SSD_TOL,
            "ms": ms, "cpu_s": cpu_s, "f32_operations": ops, "bytes": moved,
            "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get),
            "bound_ms_by": bound}
    del x, dt, a, bm, cm, y, st
    if not (err_y <= SSD_TOL and err_s <= SSD_TOL):
        raise AssertionError(f"ssd_chunked on the card strays from the CPU: {case}")
    return case


def ssd_share(torch, eng, params, prompts) -> dict:
    """The SSD scan's share of one exact prefill: every ``ssd_chunked`` call
    of ``models.ssm`` bracketed by CUDA events (its device-timeline span,
    host gaps inside it included), against the prefill's wall time."""
    import repro_torch.models.ssm as ssm_mod

    inner = ssm_mod.ssd_chunked
    spans = []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    ssm_mod.ssd_chunked = timed
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill_fn(params, prompts)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        ssm_mod.ssd_chunked = inner
    ssd_ms = sum(start.elapsed_time(end) for start, end in spans)
    return {"calls": len(spans), "ssd_ms": ssd_ms, "ms_per_call": ssd_ms / len(spans),
            "prefill_ms": wall_ms, "share_of_prefill": ssd_ms / wall_ms}


def ssm_error_split(torch, pg, dg, x, y_d, pcfg, cfg, pos) -> dict:
    """Where one pSRAM mamba2 layer's own error comes from: the layer run
    from the exact stream's input ``x`` with each projection in turn exact
    (the dequantized words), its activation quantized alone (int8 codes
    per row times their scales against the dequantized words, f32 with
    TF32 off: no ADC) or through kernel 2, each against the exact layer's
    residual branch ``y_d - x`` (relative L2); the crest factor (max |row|
    over its RMS, median over rows) of each projection's input, which sets
    an int8 row's step; and two controls that a sound layer must not come
    near: the dt outputs (the last ``ssm_heads`` columns of ``in_proj``,
    its partial last 128-column tile) zeroed, and ``out_proj`` off by 10%."""
    import repro_torch.models.ssm as ssm_mod
    from repro_torch._device import ieee_f32
    from repro_torch.core.quantization import quantize_symmetric
    from repro_torch.models.blocks import group_fwd

    proj = ssm_mod._proj
    mp, md = pg["layer0"]["mixer"], dg["layer0"]["mixer"]
    names = {id(mp["in_proj"]): "in_proj", id(mp["out_proj"]): "out_proj"}
    crest = {}

    def run(modes):
        def patched(xx, w, c):
            name = names.get(id(w))
            mode = modes.get(name, "psram")
            if name is None or mode == "psram":
                return proj(xx, w, c)
            if mode == "crest":
                xf = xx.float().reshape(-1, xx.shape[-1])
                crest.setdefault(name, float(
                    (xf.abs().amax(-1) / xf.pow(2).mean(-1).sqrt()).median()))
                return proj(xx, w, c)
            if mode == "exact":
                return xx @ md[name]
            if mode == "activation":
                q, sx = quantize_symmetric(xx.reshape(-1, xx.shape[-1]), axis=-1)
                with ieee_f32():
                    y = (q.float() * sx.float()) @ (w["q"].float() * w["scale"])
                return y.reshape(*xx.shape[:-1], -1).to(xx.dtype)
            if mode == "dt_zeroed":
                y = proj(xx, w, c)
                y[..., -cfg.ssm_heads:] = 0
                return y
            if mode == "scale_1.1":
                return proj(xx, w, c) * 1.1
            raise ValueError(mode)

        ssm_mod._proj = patched
        try:
            y, _ = group_fwd(pg, x, pcfg, pos)
        finally:
            ssm_mod._proj = proj
        return float(torch.linalg.norm((y - x).float() - (y_d - x).float())
                     / torch.linalg.norm((y_d - x).float()))

    out = {"both": run({}),
           "in_proj_activation": run({"in_proj": "activation", "out_proj": "exact"}),
           "in_proj": run({"out_proj": "exact"}),
           "out_proj_activation": run({"in_proj": "exact", "out_proj": "activation"}),
           "out_proj": run({"in_proj": "exact"}),
           "controls": {"dt_zeroed": run({"in_proj": "dt_zeroed"}),
                        "out_proj_scale_1.1": run({"out_proj": "scale_1.1"})}}
    run({"in_proj": "crest", "out_proj": "crest"})
    out["input_crest_median"] = crest
    return out


def layer_drift(torch, pparams, pcfg, cfg, prompts, at=(1, 2, 4, 8, 16, 32, 48),
                split_at=(1, 24, 48)) -> dict:
    """The pSRAM model against the exact model on its dequantized words,
    layer by layer, on one prefill's tokens: each layer's own error (its
    residual branch run on pSRAM and exactly from the exact stream's input,
    relative L2), its split by projection (:func:`ssm_error_split`) at the
    layers ``split_at``, and the drift of the two streams (relative L2 of
    the hidden states after ``at`` layers, each stream run on its own). A
    layer that computes garbage shows in its own error; an error that grows
    through the stack while each layer's stays small is the model
    amplifying the quantization, not a fault of one projection."""
    from repro_torch.models.blocks import group_fwd
    from repro_torch.models.layers import as_dtype
    from repro_torch.models.transformer import _embed, _positions

    dparams = dequantized(pparams, as_dtype(cfg.dtype))

    def rel(a, b):
        return float(torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float()))

    with torch.inference_mode():
        x_d = _embed(dparams, prompts, cfg)
        x_p = x_d
        pos = _positions(cfg, *prompts.shape, x_d.device)
        own, drift, split = [], {}, {}
        for i, (pg, dg) in enumerate(zip(pparams["blocks"], dparams["blocks"]), start=1):
            y_d, _ = group_fwd(dg, x_d, cfg, pos)
            y_own, _ = group_fwd(pg, x_d, pcfg, pos)
            own.append(rel(y_own - x_d, y_d - x_d))
            if i in split_at:
                split[i] = ssm_error_split(torch, pg, dg, x_d, y_d, pcfg, cfg, pos)
            x_p, _ = group_fwd(pg, x_p, pcfg, pos)
            x_d = y_d
            if i in at:
                drift[i] = rel(x_p, x_d)
    del dparams
    return {"layer_own_rel_l2_max": max(own), "layer_own_rel_l2_median": statistics.median(own),
            "layer_own_rel_l2": own, "own_split": split, "stream_drift_rel_l2": drift}


def main_path_ssm(torch, zero_counts, read_counts) -> tuple:
    """The ``main_path_ssm`` phase: mamba2-370m at full width and depth (48
    SSD layers, d 1024, d_inner 2048, state 128, 32 heads of 64, vocab
    50280, tied embeddings, bf16, random weights from a seed) served as
    ``main_path_serve`` serves granite-8b: 8 prompts x 1024 tokens, 64
    greedy tokens, exact and then with ``psram_projections`` and
    ``psram_stored_int8`` (``in_proj`` and ``out_proj`` through kernel 2:
    the wgmma route in a prefill, three a layer with the conv tail's
    ``in_proj``; the decode route in a step, two a layer). Reports prefill
    ms, decode ms a step, tokens/s, launches a step, the SSD's share of a
    prefill, and the pSRAM run's end-to-end distances (its prefill against
    the dequantized words, its first step against ``forward``), which the
    48 gated layers amplify and so are not gated. Checks the exact run's
    first (recurrent) decode step against the chunked ``forward``
    (relative L2 <= 0.05); kernel 2 bit-equal to its plain version on layer
    0's served operands (:func:`served_matmul_cases`: ``in_proj``'s N =
    4384 with its partial last tile, at M = 8192, 24 and 8); each pSRAM
    layer's own error against its dequantized words below
    ``MAMBA_LAYER_OWN_TOL``, with both controls of :func:`ssm_error_split`
    above it; and ``ssd_chunked`` at the served shape card against CPU.
    ``(phase, exact launches, pSRAM launches)``."""
    from repro_torch.models import get_config, transformer
    from repro_torch.serve import ServeEngine

    cfg = get_config(SSM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(17, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = seeded_prompts(torch, cfg, SERVE_BATCH, SERVE_PROMPT, 18)
    step_s, t0 = {}, time.perf_counter()
    exact_run, exact_launches, _, eng, _ = serve_run(
        torch, cfg, params, prompts, ServeEngine, zero_counts, read_counts,
        profiled_steps=NEW_FAMILY_PROFILED_STEPS)
    exact_run["ssd"] = ssd_share(torch, eng, params, prompts)
    exact_peak = torch.cuda.max_memory_allocated()
    del eng, params
    step_s["exact"], t0 = time.perf_counter() - t0, time.perf_counter()
    case = ssd_case(torch, cfg)
    step_s["ssd_case"], t0 = time.perf_counter() - t0, time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    pcfg = dataclasses.replace(cfg, psram_projections=True, psram_stored_int8=True)
    pparams = transformer.init(19, pcfg, device="cuda")
    psram_run, psram_launches, psram_logits, peng, _ = serve_run(
        torch, pcfg, pparams, prompts, ServeEngine, zero_counts, read_counts,
        profiled_steps=NEW_FAMILY_PROFILED_STEPS)
    n = cfg.num_layers
    psram_run["layer0_matmul_vs_plain"] = served_matmul_cases(
        torch, engine_stages(torch, peng, pparams, prompts), [pparams["blocks"][0]],
        ({"wgmma": 3}, {"decode": 2}), ({"wgmma": 3 * n}, {"decode": 2 * n}))
    del peng
    psram_run["prefill_vs_dequantized_rel_l2"] = psram_vs_dequantized(
        torch, transformer, pparams, (), prompts, cfg, psram_logits)
    psram_run["vs_dequantized_by_layer"] = layer_drift(torch, pparams, pcfg, cfg, prompts)
    psram_run["int8_weight_bytes"] = int8_word_bytes(pparams)
    psram_run["device_bytes_peak"] = torch.cuda.max_memory_allocated()
    del pparams, psram_logits
    torch.cuda.empty_cache()
    step_s["psram"] = time.perf_counter() - t0
    phase = {
        "phase": "main_path_ssm", "arch": SSM_ARCH, "layers": n, "d_model": cfg.d_model,
        "d_inner": cfg.d_inner_resolved, "ssm_state": cfg.ssm_state,
        "ssm_heads": cfg.ssm_heads, "ssm_headdim": cfg.ssm_headdim, "vocab": cfg.vocab_size,
        "params": cfg.param_count(), "dtype": cfg.dtype, "init_s": init_s,
        "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT, "max_new": SERVE_NEW,
        "exact": {**exact_run, "launches": exact_launches, "device_bytes_peak": exact_peak},
        "psram": {**psram_run, "launches": psram_launches},
        "psram_launches_per_decode_step": psram_launches["psram_matmul_decode"] / SERVE_NEW,
        "layer_own_tolerance": MAMBA_LAYER_OWN_TOL, "ssd_served_shape": case, "step_s": step_s,
    }
    # kernel 2: in_proj, out_proj and the conv tail's in_proj a layer in the
    # prefill (M = 8192 and 24: the wgmma route); in_proj, out_proj a step.
    # The 48 gated recurrent layers amplify a perturbation through the stack
    # (on an H100 the exact run's recurrent step, a few bf16 roundings away
    # from the chunked forward, lands 0.033 from it, and the pSRAM prefill
    # 0.58 from the dequantized words while each layer's own error is ~0.05):
    # the pSRAM run's end-to-end distances are reported, and its garbage
    # check is each layer's own error, a limit its controls must exceed
    check_served("mamba2", phase, {"wgmma": 3 * n, "tile": 0, "decode": 2 * n * SERVE_NEW},
                 decode_gated=("exact",), dequantized_gated=False)
    by_layer = psram_run["vs_dequantized_by_layer"]
    if not by_layer["layer_own_rel_l2_max"] < MAMBA_LAYER_OWN_TOL:
        raise AssertionError(f"a pSRAM mamba2 layer strays from its dequantized words by "
                             f"more than {MAMBA_LAYER_OWN_TOL}: {phase}")
    controls = [v for split in by_layer["own_split"].values()
                for v in split["controls"].values()]
    if not min(controls) > MAMBA_LAYER_OWN_TOL:
        raise AssertionError(f"a wrong projection passes the pSRAM mamba2 layer gate "
                             f"({MAMBA_LAYER_OWN_TOL}): {phase}")
    if exact_run["ssd"]["calls"] != n:
        raise AssertionError(f"a mamba2 prefill made {exact_run['ssd']['calls']} SSD scans, "
                             f"not {n}: {phase}")
    return phase, exact_launches, psram_launches


def main_path_encdec(torch, zero_counts, read_counts) -> tuple:
    """The ``main_path_encdec`` phase: seamless-m4t-large-v2 at full width
    and depth (24 encoder + 24 decoder layers, d 1024, 16 heads of 64, d_ff
    8192 gelu, vocab 256206, bf16, random weights from a seed): stub frames
    8 x 1024 x 1024 from a seeded generator, decoder prompts 8 x 256 tokens
    (``ENC_DEC_FRAC``), 64 greedy tokens through ``ServeEngine.generate(
    frames=)``, exact and then pSRAM (every projection but ``frame_proj``
    and the head through kernel 2: 6 an encoder layer and 10 a decoder
    layer in the prefill on the wgmma route, 8 a decoder layer a step on the
    decode route). Reports encode ms, prefill ms, decode ms a step,
    tokens/s, launches a step; checks the first decode step against
    ``forward`` (relative L2 <= 0.05), the pSRAM prefill against the
    dequantized words (< 0.5), and kernel 2 bit-equal to its plain version
    on the first encoder and decoder layers' served operands
    (:func:`served_matmul_cases`: K = 8192 in ``wo``, the decoder's M =
    2048, the cross K/V on the encoder's M = 8192, a step's M = 8).
    ``(phase, exact launches, pSRAM launches)``."""
    from repro_torch.models import encdec, get_config
    from repro_torch.models.layers import as_dtype
    from repro_torch.serve import ServeEngine

    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = encdec.init(21, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = torch.randn((SERVE_BATCH, SERVE_PROMPT, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(22)) \
        .to(as_dtype(cfg.dtype))
    dec_len = int(SERVE_PROMPT * ENC_DEC_FRAC)
    prompts = seeded_prompts(torch, cfg, SERVE_BATCH, dec_len, 23)
    step_s, t0 = {}, time.perf_counter()
    exact_run, exact_launches, _, eng, _ = serve_run(
        torch, cfg, params, prompts, ServeEngine, zero_counts, read_counts, frames=frames,
        profiled_steps=NEW_FAMILY_PROFILED_STEPS)
    with torch.inference_mode():
        exact_run["encode_ms"] = time_ms(torch, lambda: encdec.encode(params, frames, cfg),
                                         warmup=1, iters=3, reps=2)
    exact_peak = torch.cuda.max_memory_allocated()
    del eng, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s["exact"], t0 = time.perf_counter() - t0, time.perf_counter()

    pcfg = dataclasses.replace(cfg, psram_projections=True, psram_stored_int8=True)
    pparams = encdec.init(24, pcfg, device="cuda")
    psram_run, psram_launches, psram_logits, peng, _ = serve_run(
        torch, pcfg, pparams, prompts, ServeEngine, zero_counts, read_counts, frames=frames,
        profiled_steps=NEW_FAMILY_PROFILED_STEPS)
    enc, dec = cfg.enc_layers, cfg.dec_layers
    # the prefill: q, k, v, o, wi, wo an encoder layer; self q, k, v, o, the
    # cross k, v on the encoder's states, the cross q, o, wi, wo a decoder
    # layer. A step: self q, k, v, o, cross q, o, wi, wo a decoder layer
    n_proj = (6 * enc + 10 * dec, 8 * dec)
    psram_run["layer0_matmul_vs_plain"] = served_matmul_cases(
        torch, engine_stages(torch, peng, pparams, prompts, lead=(frames,)),
        [pparams["encoder"][0], pparams["decoder"][0]], ({"wgmma": 16}, {"decode": 8}),
        ({"wgmma": n_proj[0]}, {"decode": n_proj[1]}))
    del peng
    with torch.inference_mode():
        psram_run["encode_ms"] = time_ms(torch, lambda: encdec.encode(pparams, frames, pcfg),
                                         warmup=1, iters=3, reps=2)
    psram_run["prefill_vs_dequantized_rel_l2"] = psram_vs_dequantized(
        torch, encdec, pparams, (frames,), prompts, cfg, psram_logits)
    psram_run["int8_weight_bytes"] = int8_word_bytes(pparams)
    psram_run["device_bytes_peak"] = torch.cuda.max_memory_allocated()
    del pparams, psram_logits, frames
    torch.cuda.empty_cache()
    step_s["psram"] = time.perf_counter() - t0
    phase = {
        "phase": "main_path_encdec", "arch": ENCDEC_ARCH, "enc_layers": enc, "dec_layers": dec,
        "d_model": cfg.d_model, "heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "params": cfg.param_count(), "dtype": cfg.dtype, "init_s": init_s,
        "batch": SERVE_BATCH, "frames": SERVE_PROMPT, "prompt_len": dec_len,
        "max_new": SERVE_NEW,
        "exact": {**exact_run, "launches": exact_launches, "device_bytes_peak": exact_peak},
        "psram": {**psram_run, "launches": psram_launches},
        "psram_launches_per_decode_step": psram_launches["psram_matmul_decode"] / SERVE_NEW,
        "step_s": step_s,
    }
    check_served("seamless", phase, {"wgmma": n_proj[0], "tile": 0,
                                     "decode": n_proj[1] * SERVE_NEW})
    return phase, exact_launches, psram_launches


def rope_case(torch, cfg, params, prompts) -> dict:
    """``apply_rope`` with three distinct position streams (t the token
    index, h and w a 32 x 32 grid of patches) on layer 0's served q (bf16)
    on the card against the same on the CPU. The angles must be bit-equal
    (the inverse frequencies are the CPU's on both). What may differ is
    cos/sin (the card's libm against the CPU's): their bf16 tables must lie
    within one bf16 ulp of the CPU's, and the output within what one such
    ulp in each table can move it through the bf16 products and their sum,
    ``5 * 2^-8 * (|x_rot| + |rot_half(x_rot)|)``; its bit-equal share and
    its largest difference in bf16 ulps of the larger term are reported. In
    f32 the output must lie within ``2^-20 * (|x_rot| + |rot_half(x_rot)|)``."""
    from repro_torch.models.layers import _proj, _rope_angles, _rot_half, apply_rope, rmsnorm

    b, s = prompts.shape
    with torch.inference_mode():
        p0 = params["blocks"][0]["layer0"]
        x0 = rmsnorm(p0["pre_norm"], params["embed"][prompts], cfg.norm_eps)
        q = _proj(x0, p0["mixer"]["wq"], cfg).reshape(b, s, cfg.n_heads, cfg.head_dim)
        idx = torch.arange(s, device="cuda")
        pos = torch.stack([idx, idx // 32, idx % 32])[:, None].expand(3, b, s).to(torch.int32)
        ang = _rope_angles(pos, cfg.head_dim, cfg)
        ang_cpu = _rope_angles(pos.cpu(), cfg.head_dim, cfg)
        tables = {}
        for name, fn in (("cos", torch.cos), ("sin", torch.sin)):
            got_t, want_t = fn(ang).to(q.dtype).float().cpu(), fn(ang_cpu).to(q.dtype).float()
            tables[name] = {"equal_share": float((got_t == want_t).float().mean()),
                            "within_one_bf16_ulp": bool(((got_t - want_t).abs() <= bf16_ulp(
                                torch, torch.maximum(got_t.abs(), want_t.abs()))).all())}
        qc = q.cpu()
        terms = qc.float().abs() + _rot_half(qc.float()).abs()
        larger = torch.maximum(qc.float().abs(), _rot_half(qc.float()).abs())
        diff = (apply_rope(q, pos, cfg).float().cpu() - apply_rope(qc, pos.cpu(), cfg).float()).abs()
        diff32 = (apply_rope(q.float(), pos, cfg).cpu()
                  - apply_rope(qc.float(), pos.cpu(), cfg)).abs()
        case = {"shape": list(q.shape), "dtype": str(q.dtype).replace("torch.", ""),
                "streams": "t = index, h = index // 32, w = index % 32",
                "angles_bit_equal": bool(torch.equal(ang.cpu(), ang_cpu)), "tables": tables,
                "bit_equal_share": float((diff == 0).float().mean()),
                "max_abs_err": float(diff.max()),
                "max_err_bf16_ulps_of_larger_term": float(
                    (diff / (2.0 ** -7 * larger).clamp_min(1e-30)).max()),
                "f32_bit_equal_share": float((diff32 == 0).float().mean()),
                "f32_max_err_over_terms": float((diff32 / terms.clamp_min(1e-30)).max()),
                "tolerance": "angles bit-equal; bf16 cos/sin tables within one bf16 ulp; "
                             "bf16 output within 5 * 2^-8 (|x_rot| + |rot_half(x_rot)|); "
                             "f32 output within 2^-20 of the same"}
        ok = (case["angles_bit_equal"] and all(t["within_one_bf16_ulp"] for t in tables.values())
              and bool((diff <= 5 * 2.0 ** -8 * terms).all())
              and bool((diff32 <= 2.0 ** -20 * terms).all()))
        del x0, q, qc, ang, terms, larger, diff, diff32
    if not ok:
        raise AssertionError(f"M-RoPE on the card strays from the CPU: {case}")
    return case


def main_path_mrope(torch, zero_counts, read_counts) -> tuple:
    """The ``main_path_mrope`` phase: qwen2-vl-7b at full width (d 3584, 28
    heads, 4 kv heads, head dim 128, d_ff 18944, vocab 152064, bf16, random
    weights), its depth cut to ``MROPE_LAYERS``: 8 prompts x 1024 tokens
    with M-RoPE's text streams, ``MROPE_NEW`` greedy tokens, exact. Checks
    the first decode step against ``forward`` (relative L2 <= 0.05) and
    ``apply_rope`` with three distinct streams card against CPU
    (:func:`rope_case`). ``(phase, launches)``."""
    from repro_torch.models import get_config, transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(MROPE_ARCH), num_layers=MROPE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(25, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = seeded_prompts(torch, cfg, SERVE_BATCH, SERVE_PROMPT, 26)
    run, launches, _, eng, _ = serve_run(torch, cfg, params, prompts, ServeEngine,
                                         zero_counts, read_counts, new=MROPE_NEW,
                                         profiled_steps=NEW_FAMILY_PROFILED_STEPS)
    del eng
    case = rope_case(torch, cfg, params, prompts)
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    phase = {
        "phase": "main_path_mrope", "arch": MROPE_ARCH, "layers": cfg.num_layers,
        "layers_published": get_config(MROPE_ARCH).num_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "vocab": cfg.vocab_size, "mrope_sections": list(cfg.mrope_sections),
        "params": cfg.param_count(), "dtype": cfg.dtype, "init_s": init_s,
        "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT, "max_new": MROPE_NEW,
        "exact": {**run, "launches": launches, "device_bytes_peak": peak},
        "rope_card_vs_cpu": case,
    }
    check_served("qwen2-vl", phase)
    return phase, launches


# ------------------------------------------------------- the paged serve loop


def loop_rows(torch, loop, reqs):
    """Admit ``reqs`` into ``loop``'s pages, prefill each through the loop
    and extend it by the slot its next token takes: the loop's own rows
    (``_Active``) of one decode step at mixed lengths. Returns the rows."""
    from repro_torch.serve.loop import _Active

    rows = []
    for row, req in enumerate(reqs):
        if not loop.kv.admit(req.rid, req.prompt_len):
            raise AssertionError(f"request {req.rid} does not fit the paged cache")
        tok = loop._prefill_one(req)
        loop.kv.extend(req.rid, 1)
        rows.append(_Active(req=req, row=row, admit_seq=row, next_token=tok,
                            pos=req.prompt_len, generated=[tok]))
    return rows


def paged_summary(rep) -> dict:
    """A run's ``summary()`` plus the counts the phase checks."""
    out = rep.summary()
    out.update(n_prefills=rep.n_prefills, n_steps=rep.n_steps,
               batch_sizes=[o["batch"] for o in rep.offload],
               step_s=[o["measured_s"] for o in rep.offload])
    return out


def check_paged(name, rep, n_requests, max_preemptions):
    """Every request accounted for, no page leaked, and no request failed
    that did not hit a limit (the streams set no deadline, so only the
    preemption cap)."""
    s = rep.summary()
    if s["leaked_pages"] != 0 or s["completed"] + s["rejected"] + s["failed"] != n_requests:
        raise AssertionError(f"the paged loop ({name}) leaked pages or lost requests: {s}")
    for r in rep.failed:
        if not (r.failure == "preempt-limit" and r.preemptions > max_preemptions):
            raise AssertionError(f"the paged loop ({name}) failed request {r.rid} that hit "
                                 f"no limit: {r}")


def paged_profile(torch, loop, rows, n: int) -> dict:
    """One decode step of ``rows`` through the loop: ``n`` steps under
    ``torch.profiler`` (:func:`device_profile`), the gather (one
    ``index_select``) and the scatter (the deltas' stack + one
    ``index_copy_``) timed alone by CUDA events at the step's view and at
    a 2048-slot view (all rows at the sacrificial slot), and the step's
    own peak memory at both."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    inputs = loop._step_inputs(rows)
    out = {"rows": len(rows), "lengths": [a.pos for a in rows]}
    b, pad = loop.loop_cfg.max_batch, loop._pad_slot
    with torch.inference_mode():
        loop._decode(*inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                loop._decode(*inputs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        out.update(steps=n, **device_profile(torch, prof, wall_ms, n, "_per_step"))
        wide = (inputs[0] * 0, inputs[1] * 0, np.full((b, 2048), pad, np.int32),
                np.full(b, pad, np.int32))
        for label, host in (("step", inputs), ("view_2048", wide)):
            tok_d, pos_d, idx_d, new_d = loop._to_device(*host)
            _, deltas = loop._step_fn(loop.params, loop._view(idx_d), tok_d, pos_d)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loop._decode(*host)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            view_bytes = loop.slab[:, :, :1].nbytes * b * host[2].shape[1]
            out[label] = {
                "view": int(host[2].shape[1]), "view_bytes": view_bytes,
                "step_bytes_peak": peak,
                # the gather reads each slot it copies and writes the view
                "gather_ms": time_ms(torch, lambda: loop._view(idx_d)),
                "gather_bound_ms": 1e3 * 2 * view_bytes / HBM_BYTES_PER_S,
                "scatter_ms": time_ms(torch, lambda: loop._scatter(deltas, new_d)),
            }
            del deltas
    return out


def paged_prefill_ms(torch, loop, buckets) -> dict:
    """One paged prefill's ms at each prompt bucket: the padded tokens
    through ``prefill_paged`` and their slots scattered to the sacrificial
    one (host clock around a synchronize, median of 3)."""
    import numpy as np

    out = {}
    with torch.inference_mode():
        for b in buckets:
            toks, slots = loop._to_device(np.zeros((1, b), np.int32),
                                          np.full(b, loop._pad_slot, np.int64))
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, caches = loop._prefill_fn(loop.params, toks, b - 1)
                loop._scatter(caches, slots)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
                del caches
            out[str(b)] = statistics.median(times)
    return out


def paged_vs_dense(torch, loop, rows, cfg) -> dict:
    """One paged decode step on ``rows`` (mixed lengths) against
    ``decode_step`` on a dense cache holding the same tokens for the same
    rows (prompts right-padded, a ``(B,)`` cache position): relative L2 of
    the logits, the whole step's and each row's own (the gate, in
    :func:`main_path_paged`, holds every row), and the rows whose greedy
    token agrees. Then what that check sees of a fault in the gather or the
    mask, on the shortest row: planted faults (its pages swapped with the
    longest row's, its gather one slot on, its ``cache_pos`` one on, which
    unmasks a stale slot), each read as the step's relative L2 and the
    row's own, first on the slab as it is, then with every slot outside the
    rows' live prefixes poisoned with ``PAGED_POISON``. Poisoned, the sound
    step must stay bit-equal (the mask hides every stale slot exactly);
    clean and poisoned, every planted fault's row must read above
    ``PAGED_STEP_TOL``. The planted steps write their deltas to the
    sacrificial slot."""
    import numpy as np
    from repro_torch.models import transformer

    lens = [a.pos for a in rows]
    inputs = loop._step_inputs(rows)
    paged = torch.from_numpy(loop._decode(*inputs)[:len(rows)])
    dense = torch.zeros((len(rows), max(lens)), dtype=torch.int32)
    for i, a in enumerate(rows):
        dense[i, :a.pos] = torch.from_numpy(a.req.prompt)
    with torch.inference_mode():
        _, cache = transformer.prefill(loop.params, dense.cuda(), cfg, max(lens) + 1)
        want, _ = transformer.decode_step(
            loop.params, cache,
            torch.tensor([a.next_token for a in rows], dtype=torch.int32, device="cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"), cfg)
        want = want.cpu()
        del cache

    def rel(got, row=slice(None)):
        return float(torch.linalg.norm(got[row] - want[row]) / torch.linalg.norm(want[row]))

    token, cache_pos, gather_idx, _ = inputs
    f = min(range(len(rows)), key=lambda i: lens[i])
    g = max(range(len(rows)), key=lambda i: lens[i])
    fr, gr = rows[f].row, rows[g].row
    swap = gather_idx.copy()
    swap[[fr, gr]] = gather_idx[[gr, fr]]
    shift = gather_idx.copy()
    shift[fr, :lens[f]] = loop.kv.physical_slots(rows[f].req.rid)[1:lens[f] + 1]
    pos_on = cache_pos.copy()
    pos_on[fr] += 1
    faults = {"pages_swapped": (cache_pos, swap), "gather_one_slot_on": (cache_pos, shift),
              "cache_pos_one_on": (pos_on, gather_idx)}
    pad = np.full(loop.loop_cfg.max_batch, loop._pad_slot, np.int32)

    def planted(cp, idx):
        got = torch.from_numpy(loop._decode(token, cp, idx, pad)[:len(rows)])
        return {"rel_l2": rel(got), "row_rel_l2": rel(got, f)}

    live = torch.from_numpy(np.concatenate(
        [loop.kv.physical_slots(a.req.rid)[:a.pos] for a in rows]).astype(np.int64)).cuda()

    def poison():
        with torch.inference_mode():
            keep = loop.slab.index_select(2, live)
            loop.slab.fill_(PAGED_POISON)
            loop.slab.index_copy_(2, live, keep)
            del keep

    out = {"lengths": lens, "rel_l2": rel(paged),
           "row_rel_l2": [rel(paged, i) for i in range(len(rows))],
           "greedy_equal_rows": int((paged.argmax(-1) == want.argmax(-1)).sum()),
           "faulted_row": {"length": lens[f], "swapped_with_length": lens[g]},
           "clean": {name: planted(*fault) for name, fault in faults.items()}}
    poison()
    out["poisoned_bit_equal"] = bool(torch.equal(
        torch.from_numpy(loop._decode(token, cache_pos, gather_idx, pad)[:len(rows)]), paged))
    poisoned = {}
    for name, fault in faults.items():
        poison()
        poisoned[name] = planted(*fault)
    out["poisoned"] = poisoned

    def seen(r):
        return not (math.isfinite(r["row_rel_l2"]) and r["row_rel_l2"] <= PAGED_STEP_TOL)

    if not (out["poisoned_bit_equal"] and all(map(seen, out["clean"].values()))
            and all(map(seen, poisoned.values()))):
        raise AssertionError(f"the paged step's check does not separate a sound step from a "
                             f"planted fault: {out}")
    return out


def paged_tokens_vs_engine(torch, rep, reqs, cfg, params) -> dict:
    """The share of greedy tokens equal to ``ServeEngine.generate`` at batch
    1, over the first ``PAGED_TOKENS_CHECKED`` requests to complete without
    a preemption (reported, not gated: bf16 on the card can flip a
    near-tie, and a flipped token changes the rest of its request)."""
    from repro_torch.serve import ServeEngine

    checked = []
    done = sorted((r for r in rep.completed if not r.preemptions), key=lambda r: r.finished_s)
    for rec in done[:PAGED_TOKENS_CHECKED]:
        r = reqs[rec.rid]
        eng = ServeEngine(cfg, params, max_len=r.prompt_len + rec.n_generated, device="cuda")
        toks = eng.generate(torch.tensor(r.prompt[None], device="cuda"), r.prompt_len,
                            rec.n_generated)[0].tolist()
        agree = [a == b for a, b in zip(toks, rec.tokens)]
        checked.append({"rid": rec.rid, "tokens": len(toks), "equal": sum(agree),
                        "first_differs_at": agree.index(False) if not all(agree) else None})
    total = sum(c["tokens"] for c in checked)
    return {"share": sum(c["equal"] for c in checked) / max(total, 1), "tokens": total,
            "requests": checked}


def paged_stream(torch, loop, tc, zero_counts, read_counts) -> tuple:
    """``loop.warmup`` over the stream's buckets, then the stream with the
    counts zeroed before it and read after. ``(report, launches, summary,
    requests)``."""
    from repro_torch.serve import traffic

    reqs = traffic.generate(tc)
    t0 = time.perf_counter()
    calls = loop.warmup(max(r.prompt_len for r in reqs), max(r.decode_len for r in reqs))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    zero_counts()
    rep = loop.run_sync(reqs)
    launches = read_counts()
    return rep, launches, {**paged_summary(rep), "warmup_calls": calls, "warmup_s": warm_s}, reqs


def main_path_paged(torch, zero_counts, read_counts) -> tuple:
    """The ``main_path_paged`` phase: granite-8b at full width and depth (36
    layers, bf16, 8.25 B random parameters) served by the paged loop
    (``ServeLoop``, ``PAGED_LOOP``) on the live bursty stream
    ``PAGED_TRAFFIC`` — exact, then with every projection through kernel 2
    — each after one ``warmup`` and with the counts zeroed before the
    stream and read after. Reports each run's summary (completed, rejected,
    failed, preemptions, leaked pages, latency and TTFT percentiles,
    tokens/s, measured beside modeled step seconds, offload fraction,
    utilization, fragmentation), a few profiled decode steps of 8 rows at
    mixed lengths (host and device ms, idle, launches a step, the gather's
    and the scatter's device ms, the step's own peak memory, also at a
    2048-slot view) and a prefill's ms by bucket. Checks: no page leaked,
    every request completed, rejected or failed, none failed without
    hitting a limit; every row of the paged step within ``PAGED_STEP_TOL``
    of the dense step on the same rows, and planted faults above it
    (:func:`paged_vs_dense`); kernel 2 launched exactly 7 a layer in each
    prefill (``wgmma``) and step (``decode``) and bit-equal to its plain
    version on layer 0's calls in paged prefills at buckets 8 and 128 and
    in a paged step (:func:`served_matmul_cases`). Reports the share of
    greedy tokens equal to ``generate`` at batch 1. Then
    ``PAGED_PRESSURE``'s requests at once on just more pages than the
    largest needs, exact: preemptions, no leak. ``(phase, exact, pSRAM and
    pressure launches, kernel-2 cases)``."""
    from repro_torch.kernels.psram_matmul import M_DECODE
    from repro_torch.models import get_config, transformer
    from repro_torch.serve import ServeLoop, ServeLoopConfig, TrafficConfig, traffic

    cfg = get_config(SERVE_ARCH)
    n_proj = 7 * cfg.num_layers                       # wq, wk, wv, wo, wi, wg, wo
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(31, cfg, device="cuda")
    loop = ServeLoop(cfg, params, ServeLoopConfig(**PAGED_LOOP), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tc = TrafficConfig(**PAGED_TRAFFIC)
    rep, exact_launches, exact, reqs = paged_stream(torch, loop, tc, zero_counts, read_counts)
    check_paged("exact", rep, tc.n_requests, loop.loop_cfg.max_preemptions)
    exact["launches"] = exact_launches
    exact["slab_bytes"] = loop.slab.nbytes
    exact["prefill_ms_by_bucket"] = paged_prefill_ms(
        torch, loop, sorted({loop._bucket(r.prompt_len) for r in reqs}))
    rows = loop_rows(torch, loop, reqs[:loop.loop_cfg.max_batch])
    exact["decode_profile"] = paged_profile(torch, loop, rows, PAGED_PROFILED_STEPS)
    exact["paged_vs_dense"] = paged_vs_dense(torch, loop, rows, cfg)
    for a in rows:
        loop.kv.free_request(a.req.rid)
    exact["tokens_vs_generate"] = paged_tokens_vs_engine(
        torch, rep, {r.rid: r for r in reqs}, cfg, params)
    exact["device_bytes_peak"] = torch.cuda.max_memory_allocated()
    del loop
    torch.cuda.empty_cache()

    # page pressure: every request at once on just more pages than the
    # largest one needs
    ptc = dataclasses.replace(tc, **PAGED_PRESSURE)
    page = PAGED_LOOP["page_size"]
    pages = max(-(-(r.prompt_len + r.decode_len) // page) for r in traffic.generate(ptc)) + 1
    ploop = ServeLoop(cfg, params, ServeLoopConfig(**{**PAGED_LOOP, "num_pages": pages},
                                                   speedup=1e9), device="cuda")
    prep, pressure_launches, pressure, _ = paged_stream(torch, ploop, ptc, zero_counts,
                                                        read_counts)
    check_paged("pressure", prep, ptc.n_requests, ploop.loop_cfg.max_preemptions)
    pressure["num_pages"] = pages
    if prep.preemptions < 1:
        raise AssertionError(f"the page-pressure run preempted nothing: {pressure}")
    del ploop, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    pcfg = dataclasses.replace(cfg, psram_projections=True, psram_stored_int8=True)
    pparams = transformer.init(33, pcfg, device="cuda")
    ploop = ServeLoop(pcfg, pparams, ServeLoopConfig(**PAGED_LOOP), device="cuda")
    prep, psram_launches, psram, _ = paged_stream(torch, ploop, tc, zero_counts, read_counts)
    check_paged("pSRAM", prep, tc.n_requests, ploop.loop_cfg.max_preemptions)
    psram["launches"] = psram_launches
    # a prefill's bucket of at most M_DECODE rows takes the decode route, a
    # larger one the wgmma route (the stream's prompts are 32 tokens or more)
    admitted = [(r, 0 if r.rejected else r.preemptions + (r.failure != "preempt-limit"))
                for r in prep.records]
    small = sum(n for r, n in admitted if ploop._bucket(r.prompt_len) <= M_DECODE)
    if sum(n for _, n in admitted) != prep.n_prefills:
        raise AssertionError(f"the pSRAM run's prefills do not add up: {psram}")
    want = {"wgmma": n_proj * (prep.n_prefills - small), "tile": 0,
            "decode": n_proj * (prep.n_steps + small)}
    got = {r: psram_launches[f"psram_matmul_{r}"] for r in want}
    if got != want or exact_launches["psram_matmul"] != 0:
        raise AssertionError(f"the paged loop did not launch kernel 2 as its projections ask "
                             f"({want}; got {got}, exact {exact_launches['psram_matmul']})")
    # layer 0's calls in the loop's own prefills at buckets 8 (the decode
    # route) and 128 (wgmma), then in one paged step of those two rows
    longest = max(reqs, key=lambda r: r.prompt_len).prompt
    probe = [traffic.Request(rid=-1 - i, arrival_s=0.0, decode_len=2, prompt=longest[:n])
             for i, n in enumerate((8, 100))]
    try:
        cases = served_matmul_cases(
            torch, (lambda: loop_rows(torch, ploop, probe),
                    lambda rows: ploop._decode(*ploop._step_inputs(rows))),
            [pparams["blocks"][0]], ({"decode": 7, "wgmma": 7}, {"decode": 7}),
            ({"decode": n_proj, "wgmma": n_proj}, {"decode": n_proj}))
    finally:
        for r in probe:
            ploop.kv.free_request(r.rid)
    psram["device_bytes_peak"] = torch.cuda.max_memory_allocated()
    del ploop, pparams
    torch.cuda.empty_cache()
    phase = {
        "phase": "main_path_paged", "arch": SERVE_ARCH, "layers": cfg.num_layers,
        "params": cfg.param_count(), "dtype": cfg.dtype, "init_s": init_s,
        "loop": PAGED_LOOP, "traffic": tc.asdict(),
        "requests": [[r.prompt_len, r.decode_len] for r in reqs],
        "exact": exact, "pressure": {**pressure, "launches": pressure_launches},
        "psram": psram, "layer0_matmul_vs_plain": cases,
    }
    rel = max(exact["paged_vs_dense"]["row_rel_l2"])
    if not (math.isfinite(rel) and rel <= PAGED_STEP_TOL):
        raise AssertionError(f"the paged step drifts from the dense step: {phase}")
    return phase, exact_launches, psram_launches, pressure_launches, cases


def tree_pairs(got, want):
    """``(path, got, want)`` for every per-group tensor of two trees of one
    layout (``_tree.leaf_sets``)."""
    from repro_torch._tree import leaf_sets

    ref = dict(leaf_sets(want))
    for path, leaf in leaf_sets(got):
        ws = ref[path]
        for a, b in zip(leaf, ws) if isinstance(leaf, list) else [(leaf, ws)]:
            yield path, a, b


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, on the host."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def master_drift(got, want, lr: float) -> dict:
    """Two f32 masters after the same train steps: the elements beyond 1e-6
    of their leaf's max |want|, of how many, and the worst difference in
    units of ``lr``."""
    far = n = 0
    worst = 0.0
    for _, a, b in tree_pairs(got, want):
        a, b = a.detach().cpu(), b.detach().cpu()
        d = (a - b).abs()
        far += int((d > 1e-6 * float(b.abs().max())).sum())
        n += b.numel()
        worst = max(worst, float(d.max()) / lr)
    return {"master_elements": n, "master_beyond_1e6": far, "master_worst_in_lr": worst}


def train_card_vs_cpu(torch, cfg) -> dict:
    """One train step of the reduced ``cfg`` (f32, TF32 off) on the card
    against the same step on the CPU, from the same params and batch: the
    loss (<= 1e-5 relative) and every gradient leaf (<= 1e-4 of its max |g|),
    the CPU tests' tolerances against the reference; the update alone on the
    CPU's own gradients, master, m and v each <= 1e-6 of its leaf's max; the
    whole step's loss, grad norm and lr <= 1e-5 relative and its master, the
    elements beyond 1e-6 of their leaf's max counted (Adam's first update is
    about lr * sign(g): a gradient under its tolerance may flip it; the
    embedding's backward adds with atomics on the card) — at most 1e-3 of
    them, each within 2 lr."""
    from repro_torch._tree import tree_map
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.train import init_train_state, make_loss_fn, make_train_step
    from repro_torch.train.step import _value_and_grad

    dc = DataConfig(vocab_size=cfg.vocab_size, **TRAIN_SMALL_DATA)
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    tokens, labels = batch_at_step(dc, 0, device="cpu")
    batch = {"tokens": tokens, "labels": labels}

    def card(tree):
        return tree_map(lambda t: t.to("cuda"), tree)

    params = init_train_state(0, cfg, device="cpu")[0]
    loss_c, grads_c = _value_and_grad(make_loss_fn(cfg), params, batch)
    loss_g, grads_g = _value_and_grad(make_loss_fn(cfg), card(params), card(batch))
    out = {"arch": cfg.name, "params": cfg.param_count(), "data": TRAIN_SMALL_DATA,
           "psram_projections": bool(cfg.psram_projections),
           "remat": cfg.remat_policy if cfg.remat else None,
           "loss_rel_err": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
           "grad_rel_err_max": max(rel_err(g, c) for _, g, c in tree_pairs(grads_g, grads_c))}
    _, want, _ = apply_updates(init_state(params), grads_c, oc, param_dtype=torch.float32)
    _, got, _ = apply_updates(card(init_state(params)), card(grads_c), oc,
                              param_dtype=torch.float32)
    out["update_rel_err_max"] = max(rel_err(a, b) for part in ("master", "m", "v")
                                    for _, a, b in tree_pairs(got[part], want[part]))
    step = make_train_step(cfg, oc)
    _, s_c, m_c = step(params, init_state(params), batch)
    _, s_g, m_g = step(card(params), card(init_state(params)), card(batch))
    out["metric_rel_err"] = {k: abs(float(m_g[k]) - float(m_c[k])) / abs(float(m_c[k]))
                             for k in ("loss", "grad_norm", "lr")}
    drift = master_drift(s_g["master"], s_c["master"], oc.lr)
    out.update({f"step_{key}": v for key, v in drift.items()})
    far, n, worst = (drift["master_beyond_1e6"], drift["master_elements"],
                     drift["master_worst_in_lr"])
    if not (out["loss_rel_err"] <= 1e-5 and out["grad_rel_err_max"] <= 1e-4
            and out["update_rel_err_max"] <= 1e-6
            and max(out["metric_rel_err"].values()) <= 1e-5 and worst <= 2.0 and far <= 1e-3 * n):
        raise AssertionError(f"the reduced train step on the card is not the CPU's: {out}")
    return out


def train_resume_on_card(torch, cfg) -> dict:
    """``Trainer`` on the reduced ``cfg`` on the card with a checkpoint
    directory (a temporary one): ``TRAIN_RESUME_STEPS`` steps, saved every 5
    and at the end, then a second ``Trainer`` on the same directory, which
    must resume at that step with the params and optimizer state bit-equal
    to the first one's."""
    from repro_torch._tree import leaves
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer

    dc = DataConfig(vocab_size=cfg.vocab_size, **TRAIN_SMALL_DATA)
    oc = AdamWConfig(lr=1e-3)
    with tempfile.TemporaryDirectory() as td:
        first = Trainer(cfg, dc, opt_cfg=oc, ckpt_dir=td, ckpt_every=5, device="cuda")
        losses = first.run(TRAIN_RESUME_STEPS, log_every=10 ** 9, log_fn=lambda *_: None)
        second = Trainer(cfg, dc, opt_cfg=oc, ckpt_dir=td, device="cuda")
        out = {"steps": TRAIN_RESUME_STEPS, "losses": losses,
               "committed_steps": first.ckpt.committed_steps(),
               "resumed_at": second.start_step,
               "params_bit_equal": all(torch.equal(a, b) for a, b in
                                       zip(leaves(first.params), leaves(second.params))),
               "opt_state_bit_equal": all(torch.equal(a, b) for a, b in
                                          zip(leaves(first.opt_state), leaves(second.opt_state))),
               "on_device": {str(t.device) for t in leaves(second.params)} == {"cuda:0"}}
    if not (out["resumed_at"] == TRAIN_RESUME_STEPS and out["params_bit_equal"]
            and out["opt_state_bit_equal"] and out["on_device"]):
        raise AssertionError(f"the trainer did not resume its checkpoint on the card: {out}")
    return out


_MATMUL_KERNELS = ("nvjet", "gemm", "cutlass", "xmma")


def train_profile(torch, trainer, step: int) -> dict:
    """One train step (the batch of ``step``) under ``torch.profiler``
    (:func:`device_profile`), its busy time split into the matrix products
    (cuBLAS's kernels) and the rest; then AdamW's update alone
    (``optim.apply_updates`` on zero bf16 grads, CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch._tree import tree_map
    from repro_torch.data import batch_at_step
    from repro_torch.optim import apply_updates

    tokens, labels = batch_at_step(trainer.data_cfg, step, device="cuda")
    batch = {"tokens": tokens, "labels": labels}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.params, trainer.opt_state, _ = trainer.step_fn(trainer.params,
                                                              trainer.opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out = {"steps": 1, **device_profile(torch, prof, wall_ms, 1, "_per_step")}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(k in e.key for k in _MATMUL_KERNELS)]
    out["matmul_ms_per_step"] = sum(getattr(e, "self_device_time_total", None)
                                    or e.self_cuda_time_total for e in kernels) / 1e3
    out["matmul_launches_per_step"] = sum(e.count for e in kernels)
    zeros = tree_map(torch.zeros_like, trainer.params)
    out["optimizer_ms"] = time_ms(torch, lambda: apply_updates(
        trainer.opt_state, zeros, trainer.opt_cfg), warmup=1, iters=3, reps=1)
    return out


def main_path_train(torch, zero_counts, read_counts) -> tuple:
    """The ``main_path_train`` phase: granite-8b at full width (d 4096, ff
    14336, 32 / 8 heads, vocab 49152, bf16), its depth cut to
    ``TRAIN_LAYERS`` of 36, with the reference's training settings (chunked
    attention, remat with the ``"dots"`` policy), trained by ``Trainer`` on
    the port's data stream (``TRAIN_DATA``) for ``TRAIN_STEPS`` steps of
    AdamW (``TRAIN_OPT``), the counts zeroed before and read after (no
    hand-written kernel is on this path: every count must read 0). Reports
    the losses, ms a step (the ``train/step`` stopwatch; median after the
    first two), tokens/s, ``6 N T / t`` beside the bf16 peak (labelled, no
    gain claimed), stragglers, the phase's own peak device memory (what
    earlier phases left on the card subtracted) beside the state reckoned
    at 16 B a parameter, and one step under ``torch.profiler``. Then, the
    first trainer freed, ``TRAIN_EF_STEPS`` steps with error feedback at
    the same size. Then at ``reduced()``: a step on the card against the
    CPU (:func:`train_card_vs_cpu`) and a checkpoint resume on the card
    (:func:`train_resume_on_card`). Gates: every loss finite, the mean of
    the last 5 steps under the first 5's by ``TRAIN_LOSS_DROP``.
    ``(phase, launches of the run, of the profiled step, of the EF run)``."""
    import gc

    from repro_torch.data import DataConfig
    from repro_torch.models import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS,
                              attention_impl="chunked", remat=True, remat_policy="dots")
    n_params = cfg.param_count()
    tokens = TRAIN_DATA["global_batch"] * TRAIN_DATA["seq_len"]
    dc = DataConfig(vocab_size=cfg.vocab_size, **TRAIN_DATA)
    oc = AdamWConfig(**TRAIN_OPT)
    quiet = {"log_every": 10 ** 9, "log_fn": lambda *_: None}

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def run_summary(trainer, losses, skip):
        ms = [1e3 * t for t in trainer.step_times]
        med = statistics.median(ms[skip:])
        return {"losses": losses, "step_ms": ms, "step_ms_median": med,
                "tokens_per_s": tokens / (med / 1e3),
                "stragglers": trainer.stragglers,
                "device_bytes_peak": torch.cuda.max_memory_allocated() - base}

    release()
    base = torch.cuda.memory_allocated()      # what earlier phases left on the card
    t0 = time.perf_counter()
    trainer = Trainer(cfg, dc, opt_cfg=oc, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() - base
    zero_counts()
    losses = trainer.run(TRAIN_STEPS, **quiet)
    launches = read_counts()
    plain = run_summary(trainer, losses, 2)
    flops = 6 * n_params * tokens / (plain["step_ms_median"] / 1e3)
    plain.update(first5_mean=statistics.fmean(losses[:5]), last5_mean=statistics.fmean(losses[-5:]),
                 model_flops_per_s=flops, model_flops_share_of_bf16_peak=flops / BF16_FLOPS_PER_S,
                 resident_bytes_after_init=resident, launches=launches)
    zero_counts()
    plain["profile"] = train_profile(torch, trainer, TRAIN_STEPS)
    profile_launches = read_counts()
    # the profiler's own cost inflates its window's host time: the card's
    # idle share of an unprofiled step, from the same busy time
    plain["idle_share_of_step"] = 1 - (plain["profile"]["device_busy_ms_per_step"]
                                       / plain["step_ms_median"])
    del trainer
    release()

    trainer = Trainer(cfg, dc, opt_cfg=oc, error_feedback=True, device="cuda")
    zero_counts()
    ef_losses = trainer.run(TRAIN_EF_STEPS, **quiet)
    ef_launches = read_counts()
    ef = run_summary(trainer, ef_losses, 1)
    ef["step_ms_over_plain"] = ef["step_ms_median"] / plain["step_ms_median"]
    del trainer
    release()

    small = dataclasses.replace(get_config(TRAIN_ARCH).reduced(), attention_impl="chunked",
                                remat=True, remat_policy="dots")
    phase = {
        "phase": "main_path_train", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
        "params": n_params, "dtype": cfg.dtype, "remat": cfg.remat_policy,
        "attention_impl": cfg.attention_impl, "data": TRAIN_DATA, "opt": TRAIN_OPT,
        "state_bytes_reckoned": 16 * n_params, "init_s": init_s, "tokens_per_step": tokens,
        "device_bytes_before": base,
        "bf16_peak_flops_per_s": BF16_FLOPS_PER_S, "loss_drop_gate": TRAIN_LOSS_DROP,
        "plain": plain, "error_feedback": ef,
        "reduced_card_vs_cpu": train_card_vs_cpu(torch, small),
        "reduced_resume": train_resume_on_card(torch, small),
    }
    if not all(math.isfinite(x) for x in losses + ef_losses):
        raise AssertionError(f"a training loss is not finite: {phase}")
    if not plain["last5_mean"] < plain["first5_mean"] - TRAIN_LOSS_DROP:
        raise AssertionError(f"the loss did not fall by {TRAIN_LOSS_DROP}: {phase}")
    if any(n for counts in (launches, profile_launches, ef_launches) for n in counts.values()):
        raise AssertionError(f"the training path launched a hand-written kernel: {phase}")
    return phase, launches, profile_launches, ef_launches


def dist_grad_cases(torch, cfg, params, batch) -> list:
    """Kernel 2's training gradient on the card against its plain version's:
    the operands layer 0's projections take in one forward of ``cfg`` (the
    first ``7`` calls of ``psram_matmul_trained``, recorded; no backward
    is run), each pushed back from a seeded output gradient through
    ``psram_matmul_trained`` (the kernel's ``autograd.Function``) and
    through autograd of ``psram_matmul_torch`` on the same CUDA tensors;
    and the backward as built (kernel 2 recomputing the ADC codes) timed
    beside the same arithmetic on codes saved from the forward. These
    launches are not counted on the main path."""
    import repro_torch.core.photonic_layer as photonic
    from repro_torch.kernels.psram_matmul import psram_matmul, psram_matmul_torch
    from repro_torch.train.step import make_loss_fn

    trained = photonic.psram_matmul_trained
    seen = []

    def record(qx, qw, sx, sw, adc_bits=16, saturate=True):
        if len(seen) < 7:
            seen.append((qx, qw, sx.detach().clone(), sw.detach().clone(), adc_bits))
        return trained(qx, qw, sx, sw, adc_bits=adc_bits, saturate=saturate)

    from repro_torch._tree import tree_map

    photonic.psram_matmul_trained = record
    try:
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = make_loss_fn(cfg)(live, batch)
        del loss, live
    finally:
        photonic.psram_matmul_trained = trained
    cases = []
    gen = torch.Generator(device="cuda").manual_seed(77)
    for qx, qw, sx, sw, bits in seen:
        g = torch.randn((qx.shape[0], qw.shape[1]), generator=gen, device="cuda")
        got = []
        for fn in (trained, psram_matmul_torch):
            a, b = sx.clone().requires_grad_(), sw.clone().requires_grad_()
            got.append(torch.autograd.grad(fn(qx, qw, a, b, adc_bits=bits), (a, b), g))
        # the backward as built (the codes recomputed by kernel 2 at unit
        # scales) against the same arithmetic on codes saved from the forward
        ones_x, ones_w = torch.ones_like(sx), torch.ones_like(sw)
        codes = psram_matmul(qx, qw, ones_x, ones_w, adc_bits=bits)

        def scales_grad(a):
            ga = g * a
            return (ga * sw).sum(dim=1, keepdim=True), (ga * sx).sum(dim=0, keepdim=True)

        def recompute():
            return scales_grad(psram_matmul(qx, qw, ones_x, ones_w, adc_bits=bits))

        def saved():
            return scales_grad(codes)

        cases.append({"m": qx.shape[0], "k": qx.shape[1], "n": qw.shape[1],
                      "grad_sx_bit_equal": bool(torch.equal(got[0][0], got[1][0])),
                      "grad_sw_bit_equal": bool(torch.equal(got[0][1], got[1][1])),
                      "grad_sx_max_abs": float(got[1][0].abs().max()),
                      "grad_sw_max_abs": float(got[1][1].abs().max()),
                      "backward_ms": time_ms(torch, recompute),
                      "saved_codes_backward_ms": time_ms(torch, saved),
                      "saved_codes_bytes": codes.nbytes})
        del codes
    return cases


def fit_gate(fit_exact: float, fit_other: float) -> bool:
    """The second fit gate: exact CP-ALS reached ``FIT_MIN`` and the other
    run is within ``FIT_GAP`` of it."""
    return fit_exact >= FIT_MIN and abs(fit_other - fit_exact) <= FIT_GAP


def main_path_fit(torch, cfg, zero_counts, read_counts) -> tuple:
    """The ``main_path_fit`` phase: ``hopper`` and ``exact`` CP-ALS on a
    noiseless ``lowrank_dense`` tensor (``FIT_SHAPE``, rank ``FIT_RANK``)
    through ``dense_to_coo``, ``FIT_SWEEPS`` sweeps from the same initial
    factors; each fit recomputed from its factors through ``reconstruct``;
    gated by :func:`fit_gate`, with two planted controls that must read
    outside it: the hopper factors' mode-0 rows rolled by one (the gate's
    arithmetic can fail), and a second hopper run that never sees
    ``FIT_DROP`` of the nonzeros, drawn at random, its fit taken against the
    whole tensor (a path a few percent off fails, after ALS has pulled it
    back as far as it can). ``(phase, launches of the hopper run)``."""
    from repro_torch.core.cp_als import cp_als, init_factors, reconstruct
    from repro_torch.core.mttkrp import dense_to_coo
    from repro_torch.data import lowrank_dense
    from repro_torch.sparse import COO, csf_for_mode

    t0 = time.perf_counter()
    x, _ = lowrank_dense(0, FIT_SHAPE, FIT_RANK, device="cuda")
    idx, vals = dense_to_coo(x)
    coo = COO(indices=idx, values=vals, shape=FIT_SHAPE)
    float(vals.sum())                    # the draws done on the device
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csfs = [csf_for_mode(coo, m) for m in range(3)]
    csf_s = time.perf_counter() - t0
    init = init_factors(1, FIT_SHAPE, FIT_RANK, device="cuda")
    norm_x = float(torch.linalg.norm(x))

    def fit_of(factors, lambdas):
        return 1.0 - float(torch.linalg.norm(x - reconstruct(factors, lambdas))) / norm_x

    zero_counts()
    t0 = time.perf_counter()
    hop = cp_als(None, FIT_RANK, n_iter=FIT_SWEEPS, sparse=coo, backend="hopper",
                 config=cfg, csfs=csfs, init=init, tol=0)
    hop_s = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    exact = cp_als(None, FIT_RANK, n_iter=FIT_SWEEPS, sparse=coo, backend="exact",
                   csfs=csfs, init=init, tol=0)
    exact_s = time.perf_counter() - t0
    planted = [torch.roll(hop.factors[0], 1, dims=0)] + list(hop.factors[1:])
    keep = torch.rand(vals.numel(), generator=torch.Generator(device="cuda").manual_seed(2),
                      device="cuda") >= FIT_DROP
    dropped = COO(indices=idx[keep], values=vals[keep], shape=FIT_SHAPE)
    t0 = time.perf_counter()
    hop_dropped = cp_als(None, FIT_RANK, n_iter=FIT_SWEEPS, sparse=dropped, backend="hopper",
                         config=cfg, csfs=[csf_for_mode(dropped, m) for m in range(3)],
                         init=init, tol=0)
    dropped_s = time.perf_counter() - t0
    fits = {"hopper": hop.fit, "exact": exact.fit,
            "hopper_recomputed": fit_of(hop.factors, hop.lambdas),
            "exact_recomputed": fit_of(exact.factors, exact.lambdas),
            "control": fit_of(planted, hop.lambdas),
            "control_dropped": fit_of(hop_dropped.factors, hop_dropped.lambdas)}
    phase = {
        "phase": "main_path_fit", "shape": list(FIT_SHAPE), "nnz": int(vals.numel()),
        "rank": FIT_RANK, "sweeps": FIT_SWEEPS, "fits": fits,
        "gap": hop.fit - exact.fit, "gate": {"fit_exact_min": FIT_MIN, "gap_max": FIT_GAP},
        "gate_passes": fit_gate(exact.fit, hop.fit),
        "control_passes": fit_gate(exact.fit, fits["control"]),
        "control_dropped_passes": fit_gate(exact.fit, fits["control_dropped"]),
        "dropped_share": FIT_DROP, "dropped_nnz": int(vals.numel() - dropped.nnz),
        "iters": {"hopper": hop.iters, "exact": exact.iters},
        "host_preprocessing_s": synth_s + csf_s, "synth_s": synth_s, "csf_build_s": csf_s,
        "cp_als_hopper_s": hop_s, "cp_als_exact_s": exact_s,
        "control_dropped_s": dropped_s, "launches": launches,
        "factors_on": sorted({str(f.device) for f in hop.factors + exact.factors}),
    }
    if not all(math.isfinite(v) for v in fits.values()):
        raise AssertionError(f"non-finite fit: {phase}")
    if not phase["gate_passes"]:
        raise AssertionError(f"the fit gate failed (fit_exact >= {FIT_MIN}, hopper within "
                             f"{FIT_GAP}): {phase}")
    if phase["control_passes"] or phase["control_dropped_passes"]:
        raise AssertionError(f"a planted control passed the fit gate: {phase}")
    for name in ("hopper", "exact"):
        if abs(fits[name] - fits[f"{name}_recomputed"]) > 1e-3:
            raise AssertionError(f"{name}'s reported fit is not its factors' fit: {phase}")
    if launches["stream_mttkrp_fused_chunk"] < 3 * FIT_SWEEPS \
            or launches["stream_mttkrp_fused"] != launches["stream_mttkrp_fused_chunk"]:
        raise AssertionError(f"the hopper run did not launch kernel 1's chunk route a "
                             f"mode a sweep: {phase}")
    if not all(d.startswith("cuda") for d in phase["factors_on"]):
        raise AssertionError(f"the factors left the card: {phase}")
    return phase, launches


def main_path_examples(torch, zero_counts, read_counts) -> tuple:
    """The ``main_path_examples`` phase: every example of
    ``repro_torch.examples`` run in this process on the card through its
    ``main`` (``EXAMPLE_ARGS``), the counts zeroed before each and read
    after; its seconds, the device of a tensor it computed, its returned
    figures, its printed lines and its hand-written launches. An example
    that raises fails the phase: each asserts its own contract (backend_tour
    every row within its ``rel_tol``, the serve examples no leaked page,
    train_lm the restart's step, fault_tolerance its recoveries). The phase
    adds what the examples do not check: every result on the card,
    photonic_offload's kernel 2 bit-exact against the oracle and launched,
    backend_tour's ``hopper`` row through kernel 4, ABFT's corrected rel err
    exactly 0, and ``EXAMPLES_BUDGET_S``. ``(phase, [launches of each
    example])``."""
    import importlib
    import io

    runs, all_launches, t_phase = {}, [], time.perf_counter()
    for name, args in EXAMPLE_ARGS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        out = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            figures = mod.main([*args, "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        all_launches.append(launches)
        runs[name] = {"args": list(args), "s": seconds, "device": figures["device"],
                      "launches": {k: v for k, v in launches.items() if v},
                      "figures": figures, "lines": out.getvalue().splitlines()}
    phase = {"phase": "main_path_examples", "examples": runs,
             "examples_s": time.perf_counter() - t_phase,
             "script_s": time.perf_counter() - _START[0]}

    def fail(why):
        raise AssertionError(f"{why}: {json.dumps(phase, default=str)}")

    for name, run in runs.items():
        if not run["device"].startswith("cuda"):
            fail(f"{name}'s results are not on the card")
    photonic = runs["photonic_offload"]
    if photonic["figures"]["kernel_max_abs_diff"] != 0.0 \
            or photonic["figures"]["kernel_lowering"] != "cuda" \
            or not photonic["launches"].get("psram_matmul"):
        fail("photonic_offload's kernel 2 is not bit-exact against the oracle or was "
             "not launched")
    if not runs["backend_tour"]["launches"].get("mttkrp_psram_strided"):
        fail("backend_tour's hopper row launched no hand-written kernel")
    faults = runs["fault_tolerance"]["figures"]
    if faults["matmul_corrected_rel_err"] != 0.0 or faults["mttkrp_corrected_rel_err"] != 0.0:
        fail("fault_tolerance's ABFT recovery is not exact")
    if phase["examples_s"] > EXAMPLES_BUDGET_S:
        fail(f"the examples took more than {EXAMPLES_BUDGET_S} s")
    return phase, all_launches


def main_path_dist(torch, cfg, csf, zero_counts, read_counts) -> tuple:
    """The ``main_path_dist`` phase (see the module docstring, 7): the meta
    dry run, card cells A (exact decode) and B (pSRAM training), the
    ``ServeEngine`` on the card mesh and ``partition_csf(mesh=)``.
    ``(phase, launches of cell A, of cell B, of the mesh serve)``."""
    import gc

    from repro_torch._tree import leaves
    from repro_torch.dist.sharding import use_sharding
    from repro_torch.kernels.psram_matmul import ROUTES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_array_mesh, make_host_mesh, make_production_mesh
    from repro_torch.models import get_config, get_module
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve import ServeEngine, make_prefill
    from repro_torch.sparse import partition_csf

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    step_s, t0 = {}, time.perf_counter()

    # the meta dry run on both production meshes
    rows = []
    for multi in (False, True):
        mesh = make_production_mesh(multi)
        for arch, names in DIST_META_CELLS:
            for name in names:
                built, why = dryrun.build_cell(arch, name)
                if built is None:
                    rows.append({"arch": arch, "shape": name, "mesh": "x".join(
                        map(str, mesh.shape)), "status": "SKIP", "why": why})
                    print(f"SKIP  {arch:24s} {name:12s} {rows[-1]['mesh']}: {why}", flush=True)
                    continue
                res, _ = dryrun.lower_cell(*built, mesh, verbose=True)
                r = res["roofline"]
                rows.append({"arch": arch, "shape": name, "mesh": res["mesh"], "status": "OK",
                             "fsdp": res["fsdp"], "dot_flops": r["dot_flops"],
                             "bytes": r["bytes_essential"], "compute_ms": 1e3 * r["compute_s"],
                             "memory_ms": 1e3 * r["memory_s"], "dominant": r["dominant"],
                             "per_device_gb": res["memory"]["per_device_total_gb"],
                             "useful_flops_ratio": res["useful_flops_ratio"],
                             "ideal_ms": 1e3 * res["ideal_s"],
                             "roofline_fraction": res["roofline_fraction"],
                             "lower_s": res["lower_s"]})
    step_s["meta"], t0 = time.perf_counter() - t0, time.perf_counter()
    host = make_host_mesh(device="cuda")

    # card cell A: granite-8b decode_32k, exact, full width and depth
    release()
    (acfg, ashape), _ = dryrun.build_cell(DIST_ARCH, "decode_32k")
    ashape = dataclasses.replace(ashape, global_batch=DIST_DECODE_BATCH)
    zero_counts()
    a_res, a_cell = dryrun.lower_cell(acfg, ashape, host, device="cuda",
                                      repeats=DIST_DECODE_REPEATS, verbose=True)
    a_launches = read_counts()
    allocated = sum(t.nbytes for t in leaves(a_cell["params"]) + leaves(a_cell["cache"])
                    + [a_cell["batch"]["token"], a_cell["pos"]])
    del a_cell
    release()
    a_meta, _ = dryrun.lower_cell(acfg, ashape, host, device="meta", verbose=False)
    cell_a = {"arch": DIST_ARCH, "shape": "decode_32k", "cut": {"global_batch": [128,
                                                                               ashape.global_batch]},
              "layers": acfg.num_layers, "mesh": a_res["mesh"],
              "argument_bytes": a_res["memory"]["argument_bytes"],
              "argument_split": a_res["memory"]["argument_split"],
              "allocated_bytes": allocated, "dot_flops_card": a_res["roofline"]["dot_flops"],
              "dot_flops_meta": a_meta["roofline"]["dot_flops"],
              "by_op_card": a_res["roofline"]["by_op"], "ideal_s": a_res["ideal_s"],
              "compute_ms": 1e3 * a_res["roofline"]["compute_s"],
              "memory_ms": 1e3 * a_res["roofline"]["memory_s"], **a_res["measured"]}
    step_s["cell_a"], t0 = time.perf_counter() - t0, time.perf_counter()

    # card cell B: granite-8b train_4k through pSRAM projections, 8 layers
    (bcfg, bshape), _ = dryrun.build_cell(DIST_ARCH, "train_4k", exec_overrides={
        "psram_projections": True, "remat_policy": "dots"})
    bcfg = dataclasses.replace(bcfg, num_layers=DIST_TRAIN_LAYERS)
    bshape = dataclasses.replace(bshape, global_batch=DIST_TRAIN_BATCH)
    zero_counts()
    b_res, b_cell = dryrun.lower_cell(bcfg, bshape, host, microbatches=DIST_TRAIN_MICROBATCHES,
                                      opt_cfg=AdamWConfig(**DIST_TRAIN_OPT), device="cuda",
                                      repeats=DIST_TRAIN_STEPS - 1, verbose=True)
    b_launches = read_counts()
    # a pass of one microbatch: every projection's forward, its remat
    # recompute and the backward's recompute of the ADC codes; passes: the
    # counted trace (one microbatch) and the steps' microbatches
    n_proj = 7 * bcfg.num_layers
    passes = 1 + DIST_TRAIN_STEPS * DIST_TRAIN_MICROBATCHES
    want_routes = {r: (3 * n_proj * passes if r == "wgmma" else 0) for r in ROUTES}
    got_routes = {r: b_launches[f"psram_matmul_{r}"] for r in ROUTES}
    mb = {k: v[: DIST_TRAIN_BATCH // DIST_TRAIN_MICROBATCHES]
          for k, v in b_cell["batch"].items()}
    grads = dist_grad_cases(torch, bcfg, b_cell["params"], mb)
    cell_b = {"arch": DIST_ARCH, "shape": "train_4k", "psram_projections": True,
              "cut": {"layers": [36, bcfg.num_layers], "global_batch": [256, bshape.global_batch]},
              "microbatches": DIST_TRAIN_MICROBATCHES, "steps": DIST_TRAIN_STEPS,
              "opt": DIST_TRAIN_OPT, "remat": bcfg.remat_policy, "dtype": bcfg.dtype,
              "argument_bytes": b_res["memory"]["argument_bytes"],
              "dot_flops_card": b_res["roofline"]["dot_flops"],
              "ideal_s": b_res["ideal_s"], "kernel2_routes": got_routes,
              "kernel2_routes_derived": want_routes, "layer0_grads": grads,
              **b_res["measured"]}
    del b_cell
    release()
    # the whole pSRAM step, update included, at reduced() on the card
    # against the CPU (kernel 2 against its plain version; not counted)
    small = dataclasses.replace(get_config(DIST_ARCH).reduced(), psram_projections=True,
                                attention_impl="chunked", remat=True, remat_policy="dots")
    cell_b["reduced_card_vs_cpu"] = train_card_vs_cpu(torch, small)
    step_s["cell_b"], t0 = time.perf_counter() - t0, time.perf_counter()

    # ServeEngine on the card mesh, --seq-shard's rules, against mesh=None
    scfg = dataclasses.replace(get_config(DIST_ARCH), num_layers=DIST_SERVE_LAYERS)
    sparams = get_module(scfg).init(0, scfg, device="cuda")
    prompts = seeded_prompts(torch, scfg, DIST_SERVE["batch"], DIST_SERVE["prompt_len"], 41)
    rules = {"seq": (("model",), ())}
    max_len = DIST_SERVE["prompt_len"] + DIST_SERVE["max_new"]
    eng = ServeEngine(scfg, sparams, max_len=max_len, mesh=host, sharding_rules=rules)
    zero_counts()
    toks_mesh = eng.generate(prompts, DIST_SERVE["prompt_len"], DIST_SERVE["max_new"])
    serve_launches = read_counts()
    toks_plain = ServeEngine(scfg, sparams, max_len=max_len, device="cuda").generate(
        prompts, DIST_SERVE["prompt_len"], DIST_SERVE["max_new"])
    prefill = make_prefill(scfg, max_len)
    with torch.inference_mode():
        with use_sharding(host, rules=rules):
            lg_mesh, _ = prefill(sparams, prompts)
        lg_plain, _ = prefill(sparams, prompts)
    serve = {"layers": scfg.num_layers, **DIST_SERVE, "device": str(eng.device),
             "tokens_bit_equal": bool(torch.equal(toks_mesh, toks_plain)),
             "prefill_logits_bit_equal": bool(torch.equal(lg_mesh, lg_plain))}
    del eng, sparams, lg_mesh, lg_plain
    release()

    # partition_csf on a mesh of 4 arrays on the card
    by_mesh = partition_csf(csf, mesh=make_array_mesh(DIST_MESH_ARRAYS, "cuda"), rank=RANK,
                            config=cfg)
    by_count = partition_csf(csf, n_arrays=DIST_MESH_ARRAYS, rank=RANK, config=cfg)
    part = {"arrays": DIST_MESH_ARRAYS,
            "partitions_equal": by_mesh.partitions == by_count.partitions,
            "shards_equal": all(torch.equal(a.values, b.values)
                                for a, b in zip(by_mesh.shards, by_count.shards))}
    step_s["serve_and_partition"] = time.perf_counter() - t0

    phase = {"phase": "main_path_dist", "meta_rows": rows, "cell_a": cell_a, "cell_b": cell_b,
             "serve_on_mesh": serve, "partition_csf_mesh": part, "step_s": step_s,
             "peak_flops": BF16_FLOPS_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S}
    bad_rows = [r for r in rows if r["status"] == "OK" and not (r["dot_flops"] > 0
                                                               and r["bytes"] > 0)]
    if bad_rows or not any(r["status"] == "OK" for r in rows):
        raise AssertionError(f"a dry-run row has no FLOPs or bytes: {phase}")
    if cell_a["argument_bytes"] != allocated:
        raise AssertionError(f"cell A's spec-derived bytes differ from the allocated: {phase}")
    if cell_a["dot_flops_card"] != cell_a["dot_flops_meta"]:
        raise AssertionError(f"cell A's FLOPs on the card differ from the meta count: {phase}")
    if not all(math.isfinite(x) for x in cell_b["losses"]) \
            or len(cell_b["losses"]) != DIST_TRAIN_STEPS \
            or not cell_b["losses"][-1] < cell_b["losses"][0]:
        raise AssertionError(f"cell B's losses are not finite or did not fall: {phase}")
    if got_routes != want_routes:
        raise AssertionError(f"kernel 2's launches in cell B differ from the derived: {phase}")
    if len(grads) != 7 or not all(c["grad_sx_bit_equal"] and c["grad_sw_bit_equal"]
                                  for c in grads):
        raise AssertionError(f"kernel 2's gradient differs from the plain version's: {phase}")
    if not (serve["tokens_bit_equal"] and serve["prefill_logits_bit_equal"]):
        raise AssertionError(f"the mesh changed the served bits: {phase}")
    if not (part["partitions_equal"] and part["shards_equal"]):
        raise AssertionError(f"partition_csf(mesh=) differs from n_arrays=: {phase}")
    return phase, a_launches, b_launches, serve_launches


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world_of_one():
    """A world-size-1 NCCL group (``launch.mesh.init_distributed``) and its
    1 x 1 host mesh on the card; the group destroyed on leaving."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    init_distributed("cuda", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                     world_size=1)
    try:
        yield make_host_mesh(model=1, device="cuda")
    finally:
        dist.destroy_process_group()


def split_k_case(torch, m, k, n, route, seed, timed=False):
    """Kernel 2 with K split ``SPLIT_WAYS`` ways: each slice through the
    int32-out variant of ``route`` (the epilogue compiled out), the sums
    added on the card, then the epilogue launch with the whole K's full
    scale; bit-equal to the fused kernel on the whole K and to its plain
    version (:func:`psram_matmul_torch`), each slice's sums equal to the
    plain integer product, the epilogue launch equal to its plain arithmetic
    on the same summed ``acc``. Decode rows also go through the slice that
    quantizes its own rows (``rows``: f32 and bf16 rows, each with its
    whole K's scale and its own codes), each slice's sums equal to its plain version, the
    whole bit-equal to the fused kernel and to the plain version; the
    epilogue in bf16 equal to the f32 result rounded. With ``timed``: one
    slice's launch (device time of cold calls in a CUDA graph on the decode
    route, CUDA events over eager calls elsewhere) beside its plain version,
    bound and ``torch._int_mm``; the epilogue launch beside its plain
    arithmetic and its bound, by CUDA events and as device time in a graph;
    the rows slice's device time (cold, in a graph) and eager time."""
    from repro_torch.core.quantization import (QMAX, adc_transfer, exact_int_matmul,
                                               symmetric_scale)
    from repro_torch.kernels.psram_matmul import (psram_adc_epilogue, psram_matmul,
                                                  psram_matmul_int32, psram_matmul_int32_rows,
                                                  psram_matmul_int32_rows_torch,
                                                  psram_matmul_torch)

    qx, qw, sx, sw = matmul_codes(torch, m, k, n, seed)
    want = psram_matmul(qx, qw, sx, sw)
    ks = k // SPLIT_WAYS
    slices = [(qx[:, i * ks:(i + 1) * ks].contiguous(), qw[i * ks:(i + 1) * ks].contiguous())
              for i in range(SPLIT_WAYS)]
    parts = [psram_matmul_int32(a, b, route=route) for a, b in slices]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    got = psram_adc_epilogue(acc, sx, sw, k)
    fs = float(QMAX) * float(QMAX) * k
    plain = psram_matmul_torch(qx, qw, sx, sw)
    case = {"shape": [m, k, n], "route": route, "ways": SPLIT_WAYS,
            "slices_equal_plain": all(torch.equal(p, exact_int_matmul(a, b).to(torch.int32))
                                      for p, (a, b) in zip(parts, slices)),
            "epilogue_equal_plain": bool(torch.equal(
                got, adc_transfer(acc, 2 ** 16, fs) * (sx * sw))),
            "epilogue_bf16_equal": bool(torch.equal(
                psram_adc_epilogue(acc, sx, sw, k, out_dtype=torch.bfloat16),
                got.to(torch.bfloat16))),
            "bit_equal": bool(torch.equal(got, want)),
            "bit_equal_plain": bool(torch.equal(got, plain)),
            "max_abs_err": float((got - plain).abs().max())}
    ok = (case["bit_equal"] and case["bit_equal_plain"] and case["slices_equal_plain"]
          and case["epilogue_equal_plain"] and case["epilogue_bf16_equal"])
    if m <= 16:
        # f32 and bf16 rows (the codes, moved off the integers, times their
        # scales), each with its scale taken over the whole K and its own codes
        gen = torch.Generator(device="cuda").manual_seed(seed)
        xf = (qx.float() + torch.rand(qx.shape, generator=gen, device="cuda") - 0.5) * sx
        xb = xf.to(torch.bfloat16)
        rows = {}
        for name, x in (("f32", xf), ("bf16", xb)):
            s = symmetric_scale(x.abs().amax(dim=-1, keepdim=True))
            codes = torch.round(x / s).clamp(-QMAX, QMAX).to(torch.int8)
            scale = s.float()
            xs = [x[:, i * ks:(i + 1) * ks].contiguous() for i in range(SPLIT_WAYS)]
            rparts = [psram_matmul_int32_rows(a, s, b) for a, (_, b) in zip(xs, slices)]
            racc = rparts[0]
            for p in rparts[1:]:
                racc = racc + p
            rgot = psram_adc_epilogue(racc, scale, sw, k)
            rows[name] = {
                "slices_equal_plain": all(
                    torch.equal(p, psram_matmul_int32_rows_torch(a, s, b))
                    for p, a, (_, b) in zip(rparts, xs, slices)),
                "bit_equal": bool(torch.equal(rgot, psram_matmul(codes, qw, scale, sw))),
                "bit_equal_plain": bool(torch.equal(rgot, psram_matmul_torch(codes, qw, scale,
                                                                             sw))),
                "max_abs_err": float((rgot - psram_matmul_torch(codes, qw, scale, sw))
                                     .abs().max())}
            ok = ok and all(v for key, v in rows[name].items() if key != "max_abs_err")
        case["rows"] = rows
    if not ok:
        raise AssertionError(f"kernel 2's K split differs from the fused kernel or the plain "
                             f"version: {case}")
    if timed:
        a, b = slices[0]
        launch = lambda: psram_matmul_int32(a, b, route=route)  # noqa: E731
        case["ms"] = (graph_ms(torch, [launch], reps=4) if route == "decode"
                      else time_ms(torch, launch))
        case["plain_ms"] = time_ms(torch, lambda: exact_int_matmul(a, b).to(torch.int32),
                                   iters=3, reps=2)
        a32 = a if m > 16 else torch.nn.functional.pad(a, (0, 0, 0, 32 - m))
        case["library_ms"] = time_ms(torch, lambda: torch._int_mm(a32, b))
        case["library"] = "torch._int_mm" + ("" if m > 16 else f" on {m} rows padded to 32")
        bytes_ms = 1e3 * (nbytes(a, b) + 4 * m * n) / HBM_BYTES_PER_S
        ops_ms = 1e3 * 2.0 * m * ks * n / INT8_OPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        def epi(out_dtype=torch.float32):
            return psram_adc_epilogue(acc, sx, sw, k, out_dtype=out_dtype)

        epi_bf16 = lambda: epi(torch.bfloat16)  # noqa: E731
        case["epilogue"] = {
            "ms": time_ms(torch, epi), "device_ms": graph_ms(torch, [epi], reps=8),
            "bf16_ms": time_ms(torch, epi_bf16),
            "bf16_device_ms": graph_ms(torch, [epi_bf16], reps=8),
            "plain_ms": time_ms(torch, lambda: adc_transfer(acc, 2 ** 16, fs) * (sx * sw)),
            "bound_ms": 1e3 * (8.0 * m * n + nbytes(sx, sw)) / HBM_BYTES_PER_S,
            "bf16_bound_ms": 1e3 * (6.0 * m * n + nbytes(sx, sw)) / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": None}
        if m <= 16 and route == "decode":
            xb0 = xb[:, :ks].contiguous()
            sxb = symmetric_scale(xb.abs().amax(dim=-1, keepdim=True))
            ws = cold_copies(torch, b)
            case["rows"]["ms"] = graph_ms(torch, [
                lambda w=w: psram_matmul_int32_rows(xb0, sxb, w) for w in ws])
            case["rows"]["eager_ms"] = time_ms(torch, lambda: psram_matmul_int32_rows(xb0, sxb, b))
            case["rows"]["plain_ms"] = time_ms(
                torch, lambda: psram_matmul_int32_rows_torch(xb0, sxb, b))
            case["rows"]["plain_device_ms"] = graph_ms(torch, [
                lambda w=w: psram_matmul_int32_rows_torch(xb0, sxb, w) for w in ws])
            rbytes = 1e3 * (nbytes(xb0, sxb, b) + 4 * m * n) / HBM_BYTES_PER_S
            case["rows"]["bound_ms"] = max(rbytes, ops_ms)
            case["rows"]["bound_by"] = "operations" if ops_ms >= rbytes else "bytes"
    return case


def row_parallel_ops(torch, m, k, n, seed):
    """The breakdown of :func:`projection_calls` by operation: one rank's
    row-parallel pSRAM projection's pieces at bf16 rows ``(m, k)`` (its K
    slice) and ``(k, n)`` int8 words, each launch's device time (its calls
    captured in a CUDA graph; the K slice's over weight copies past the L2,
    as the decode step finds them) beside its eager time (CUDA events over
    back-to-back calls: the host's share shows). ``parent`` is the
    composition before the rows slice (the quantization ops,
    ``psram_matmul_int32``, the epilogue in f32 and the cast), ``after`` is
    the present one (decode rows: ``psram_matmul_int32_rows``; the epilogue
    in bf16), both on this tree's kernels. Neither holds the all-reduces or
    the weight's own quantization (``w=``): the whole call is
    :func:`projection_calls`'s."""
    from repro_torch.core.quantization import QMAX, symmetric_scale
    from repro_torch.kernels import psram_matmul as pm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    qw = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    sw = torch.rand((1, n), generator=gen, device="cuda") + 1e-3
    ws = cold_copies(torch, qw)
    ax = x.abs()
    amax = ax.amax(dim=-1, keepdim=True)
    amax32 = amax.to(torch.float32)
    cm = amax.clamp_min(1e-12)
    qmax = torch.full((), float(QMAX), device="cuda")
    sx = symmetric_scale(amax)
    d = x / sx
    r = torch.round(d)
    c = r.clamp(-QMAX, QMAX)
    q = c.to(torch.int8)
    acc = pm.psram_matmul_int32(q, qw)
    sx32 = sx.to(torch.float32)
    y = pm.psram_adc_epilogue(acc, sx32, sw, SPLIT_WAYS * k)
    ops = {"abs": lambda: x.abs(), "amax": lambda: ax.amax(dim=-1, keepdim=True),
           "to_f32": lambda: amax.to(torch.float32), "to_bf16": lambda: amax32.to(torch.bfloat16),
           "clamp_min": lambda: amax.clamp_min(1e-12), "div_qmax": lambda: cm / qmax,
           "div": lambda: x / sx, "round": lambda: torch.round(d),
           "clamp": lambda: r.clamp(-QMAX, QMAX), "to_int8": lambda: c.to(torch.int8),
           "slice_int32": [lambda w=w: pm.psram_matmul_int32(q, w) for w in ws],
           "sx_f32": lambda: sx.to(torch.float32),
           "epilogue_f32": lambda: pm.psram_adc_epilogue(acc, sx32, sw, SPLIT_WAYS * k),
           "to_out": lambda: y.to(torch.bfloat16),
           "epilogue_bf16": lambda: pm.psram_adc_epilogue(acc, sx32, sw, SPLIT_WAYS * k,
                                                          out_dtype=torch.bfloat16)}
    if m <= pm.M_DECODE:
        if not torch.equal(pm.psram_matmul_int32_rows(x, sx, qw), acc):
            raise AssertionError(f"the rows slice differs from the parent's composition "
                                 f"at {(m, k, n)}")
        ops["rows"] = [lambda w=w: pm.psram_matmul_int32_rows(x, sx, w) for w in ws]
    out = {}
    for name, fn in ops.items():
        fns = fn if isinstance(fn, list) else [fn]
        out[name] = {"device_ms": graph_ms(torch, fns, reps=1 if len(fns) > 1 else 8),
                     "eager_ms": time_ms(torch, fns[0])}
    scale = ("abs", "amax", "to_f32", "to_bf16", "clamp_min", "div_qmax")
    quantized = ("div", "round", "clamp", "to_int8", "slice_int32")
    parts = {"parent": scale + quantized + ("sx_f32", "epilogue_f32", "to_out"),
             "after": scale + (("rows",) if "rows" in ops else quantized)
             + ("sx_f32", "epilogue_bf16")}
    return {"shape": [m, k, n], "ways": SPLIT_WAYS, "x": "bfloat16",
            "weight_copies": len(ws), "ops": out,
            **{side: {"launches": len(names),
                      "device_ms": sum(out[o]["device_ms"] for o in names),
                      "eager_ms": sum(out[o]["eager_ms"] for o in names)}
               for side, names in parts.items()}}


#: a rank's row-parallel decode projections of granite-8b over four cards,
#: (name, rows, K slice, N): o and down
PROJECTION_SHAPES = (("o", 8, 1024, 4096), ("down", 8, 3584, 4096))


def projection_calls(torch, mesh) -> list:
    """One rank's row-parallel pSRAM decode projection as a served model
    calls it (``layers._proj`` on a weight placed row-parallel on the world-1
    ``mesh``, bf16 rows, under ``inference_mode``), at
    :data:`PROJECTION_SHAPES`, split by :func:`op_split` under
    ``torch.profiler``: its launches, its device time (``busy_ms``) and its
    CUDA-event time (``ms``), per op. It uses only names the port has had
    since its placement across cards, so ``profile_projection.py --src``
    runs it against an earlier tree. Run it in a fresh process
    (:func:`projection_run`)."""
    from repro_torch.dist.placement import distribute
    from repro_torch.dist.sharding import logical_to_spec, use_sharding
    from repro_torch.models import get_config
    from repro_torch.models.layers import _proj

    cfg = dataclasses.replace(get_config(MULTI_ARCH), psram_projections=True)
    cases = []
    for i, (name, m, k, n) in enumerate(PROJECTION_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(95 + i)
        x = torch.randn((m, 1, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        with torch.inference_mode(), use_sharding(mesh):
            xp = distribute(x, mesh, logical_to_spec(("batch", "seq", None), x.shape, mesh))
            wp = distribute(w, mesh, logical_to_spec(("ff", "embed"), w.shape, mesh))
            split = op_split(torch, lambda: _proj(xp, wp, cfg), r"psram_\w+_kernel")
        cases.append({"name": name, "shape": [m, k, n], **split})
    return cases


def rows_layouts(torch) -> list:
    """The rows slice at every layout (64-column blocks a warp, warps a CTA,
    cluster), bf16 rows, device time of cold calls in a CUDA graph, at
    ``ROWS_TUNE_SHAPES``: the evidence for the library's choice."""
    from repro_torch.core.quantization import symmetric_scale
    from repro_torch.kernels import psram_matmul as pm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for i, (m, k, n) in enumerate(ROWS_TUNE_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(90 + i)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        sx = symmetric_scale(x.abs().amax(dim=-1, keepdim=True))
        qw = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        ws = cold_copies(torch, qw)
        want = pm.psram_matmul_int32_rows(x, sx, qw)
        times = {}
        for nb in (1, 2):
            for warps in (4, 8):
                for cluster in (1, 2, 4, 8):
                    lay = pm.rows_layout(nb, warps, cluster)
                    if not torch.equal(pm.psram_matmul_int32_rows(x, sx, qw, layout=lay), want):
                        raise AssertionError(f"rows layout {nb, warps, cluster} differs")
                    times[f"{nb}x64/{warps}w/c{cluster}"] = graph_ms(torch, [
                        lambda w=w, lay=lay: pm.psram_matmul_int32_rows(x, sx, w, layout=lay)
                        for w in ws])
        lay = pm._rows_layout(k, n, sms)
        cases.append({"shape": [m, k, n], "ms": times,
                      "library": f"{lay >> 16}x64/{(lay >> 8) & 0xFF}w/c{lay & 0xFF}",
                      "best": min(times, key=times.get)})
    return cases


def paged_prefill_rows_ms(torch) -> list:
    """Kernel 2 (its route, ``wgmma``) at the paged loop's prefill rows:
    one ``time_ms`` a shape, beside its bound."""
    from repro_torch.kernels.psram_matmul import _route, psram_matmul

    cases = []
    for i, (m, k, n) in enumerate(PAGED_PREFILL_SHAPES):
        qx, qw, sx, sw = matmul_codes(torch, m, k, n, 80 + i)
        bytes_ms = 1e3 * (nbytes(qx, qw, sx, sw) + 4 * m * n) / HBM_BYTES_PER_S
        ops_ms = 1e3 * 2.0 * m * k * n / INT8_OPS_PER_S
        cases.append({"shape": [m, k, n], "route": _route(m, k, n, True),
                      "ms": time_ms(torch, lambda: psram_matmul(qx, qw, sx, sw)),
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
    return cases


def served_pair(torch, cfg, params, mesh, prompts, zero_counts, read_counts):
    """One configuration served twice, on ``mesh`` (DTensors) and with
    ``mesh=None``: the prefill's logits and the greedy tokens bit-equal, the
    launches of the mesh run, each run's wall ms."""
    from repro_torch.dist.placement import distribute, distribute_tree, full
    from repro_torch.dist.sharding import logical_to_spec, use_sharding
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine, make_prefill

    p_len, new = MULTI_SERVE["prompt_len"], MULTI_SERVE["max_new"]
    with torch.inference_mode():
        want_logits, _ = make_prefill(cfg, p_len + new)(params, prompts)
        placed = distribute_tree(params, transformer.param_specs(cfg), mesh)
        tok = distribute(prompts, mesh, logical_to_spec(("batch", "seq"), prompts.shape, mesh))
        with use_sharding(mesh):
            got_logits = full(make_prefill(cfg, p_len + new)(placed, tok)[0])
    out = {"logits_bit_equal": bool(torch.equal(got_logits, want_logits))}
    del want_logits, got_logits, placed
    plain = ServeEngine(cfg, params, max_len=p_len + new, device="cuda")
    placed_eng = ServeEngine(cfg, params, max_len=p_len + new, mesh=mesh)
    placed_eng.generate(prompts, p_len, 2)            # warm
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    got = placed_eng.generate(prompts, p_len, new)
    torch.cuda.synchronize()
    out["mesh_ms"] = 1e3 * (time.perf_counter() - t0)
    launches = read_counts()
    t0 = time.perf_counter()
    want = plain.generate(prompts, p_len, new)
    torch.cuda.synchronize()
    out["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    out["tokens_equal"] = bool(torch.equal(got, want))
    return out, launches


def projection_run() -> list:
    """:func:`projection_calls` on this tree in a process of its own
    (``profile_projection.py``, its own world-1 group, the kernels already
    built): late in a long process the profiler places some of the card's
    records before the window that holds them, and :func:`op_split` then
    finds a call's launches short in every window."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "projection.json"
        proc = subprocess.run([sys.executable, str(ROOT / "profile_projection.py"), "--out",
                               str(out)], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"profile_projection.py exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        return json.loads(out.read_text())["projection"]


def split_cases(torch, tuning=False) -> dict:
    """Kernel 2's K split at ``SPLIT_SHAPES``: the bf16 rows' quotient held
    to ``__fdiv_rn`` exhaustively (``_rows_division_probe``), every route
    case (:func:`split_k_case`, timed), the row-parallel decode projection
    as a whole (:func:`projection_run`) and by operation at each shape's K
    slice (:func:`row_parallel_ops`), and the
    ``wgmma`` route at the paged loop's prefill rows; with ``tuning`` the
    rows slice's layouts (:func:`rows_layouts`)."""
    from repro_torch.kernels.psram_matmul import _rows_division_probe

    count, first, checked = _rows_division_probe()
    out = {"rows_division_probe": {"pairs_checked": checked, "pairs_differing": count}}
    if count:
        raise AssertionError(f"the bf16 rows' quotient differs from __fdiv_rn's on {count} of "
                             f"{checked} (value, scale) pairs, the first {first:#x}")
    out.update({"split_k": [], "projection": projection_run(), "split_ops": []})
    for i, (m, k, n) in enumerate(SPLIT_SHAPES):
        for route in (("decode", "tile") if m <= 16 else ("wgmma", "tile")):
            out["split_k"].append(split_k_case(torch, m, k, n, route, seed=70 + i, timed=True))
        out["split_ops"].append(row_parallel_ops(torch, m, k // SPLIT_WAYS, n, seed=75 + i))
    out["paged_prefill"] = paged_prefill_rows_ms(torch)
    if tuning:
        out["rows_layouts"] = rows_layouts(torch)
    return out


def main_path_multicard(torch, zero_counts, read_counts, tuning=False) -> tuple:
    """The ``main_path_multicard`` phase on one card: a world-size-1 NCCL
    group (``launch.mesh.init_distributed``), granite-8b at full width and
    ``MULTI_LAYERS`` layers placed as DTensors on the 1 x 1 ``DeviceMesh``,
    exact and pSRAM, served against ``mesh=None`` (prefill logits and
    greedy tokens bit-equal; the counts zeroed before and read after each
    mesh run: the pSRAM run's o and down projections take, K split over the
    one-rank model axis, the int32 ``wgmma`` route in a prefill and the
    slice that quantizes its own rows in a decode step (the int32 decode
    route never), each followed by the epilogue launch); kernel 2's
    int32-out routes + the epilogue over a ``SPLIT_WAYS``-way K split at o's
    and down's shapes, decode rows on ``decode``, ``tile`` and the rows
    slice, prefill rows on ``wgmma`` and ``tile``, bit-equal to the fused
    kernel, and the rest of :func:`split_cases`. ``(phase, launches)``."""
    import gc

    from repro_torch.models import get_config, transformer

    t_phase = time.perf_counter()
    with world_of_one() as mesh:
        cfg = dataclasses.replace(get_config(MULTI_ARCH), num_layers=MULTI_LAYERS)
        params = transformer.init(0, cfg, device="cuda")
        prompts = seeded_prompts(torch, cfg, MULTI_SERVE["batch"], MULTI_SERVE["prompt_len"], 61)
        exact, exact_launches = served_pair(torch, cfg, params, mesh, prompts, zero_counts,
                                            read_counts)
        psram, psram_launches = served_pair(
            torch, dataclasses.replace(cfg, psram_projections=True), params, mesh, prompts,
            zero_counts, read_counts)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        unsaturated = unsaturated_split_cases(torch, mesh)
        split = split_cases(torch, tuning)
    phase = {"phase": "main_path_multicard", "cards": 1, "world": 1,
             "arch": MULTI_ARCH, "layers": MULTI_LAYERS, "serve": MULTI_SERVE,
             "exact": exact, "psram": psram,
             "launches": {"exact": exact_launches, "psram": psram_launches},
             "unsaturated_split": unsaturated, **split,
             "wall_s": time.perf_counter() - t_phase}
    # the pSRAM run's o and down: prefill rows on the int32 wgmma route,
    # decode rows on the slice that quantizes its own rows; every epilogue
    # in bf16
    ok = (exact["logits_bit_equal"] and exact["tokens_equal"] and psram["logits_bit_equal"]
          and psram["tokens_equal"]
          and psram_launches["psram_matmul_int32"] > 0 and psram_launches["psram_adc_epilogue"] > 0
          and psram_launches["psram_matmul_int32_rows"] > 0
          and psram_launches["psram_matmul_int32_decode"] == 0
          and psram_launches["psram_matmul"] > 0)
    if not ok:
        raise AssertionError(f"main_path_multicard: {phase}")
    launches = {k: exact_launches[k] + psram_launches[k] for k in exact_launches}
    return phase, launches


FOUR_PARTS = ("dbrx", "granite", "train", "ckpt", "mesh")


def _four_card_rank(rank, port, out_path, parts=FOUR_PARTS):
    """One rank of the ``--cards 4`` run (see :func:`main_path_four_cards`)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch._tree import leaves, tree_map
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig
    from repro_torch.dist.placement import distribute, full, init_placed
    from repro_torch.dist.sharding import logical_to_spec, use_sharding
    from repro_torch.kernels.psram_matmul import (psram_adc_epilogue, psram_matmul,
                                                  psram_matmul_int32, psram_matmul_int32_rows)
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.roofline import count_collectives
    from repro_torch.models import get_config, transformer
    from repro_torch.models.layers import _proj
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve import ServeEngine, make_prefill
    from repro_torch.train import Trainer

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(CARDS), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init_distributed("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def counts():
        return {"psram_matmul": dict(psram_matmul.routes),
                "psram_matmul_int32": dict(psram_matmul_int32.routes),
                "psram_matmul_int32_rows": psram_matmul_int32_rows.launches,
                "psram_adc_epilogue": psram_adc_epilogue.launches}

    def zero():
        psram_matmul.launches = psram_matmul_int32.launches = psram_adc_epilogue.launches = 0
        psram_matmul_int32_rows.launches = 0
        psram_matmul.routes = {r: 0 for r in psram_matmul.routes}
        psram_matmul_int32.routes = {r: 0 for r in psram_matmul_int32.routes}

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, 1e3 * (time.perf_counter() - t0)

    def save():
        """Rank 0 writes what it has after each part (a later failure keeps it)."""
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)

    def prompts_for(cfg, spec):
        return torch.randint(2, cfg.vocab_size, (spec["batch"], spec["prompt_len"]),
                             device="cuda", dtype=torch.int32,
                             generator=torch.Generator(device="cuda").manual_seed(5))

    mesh = make_host_mesh(model=CARDS, device="cuda")
    # (a) dbrx-132b, exact, full width and depth, on (1, 4)
    if "dbrx" in parts:
        cfg = get_config("dbrx_132b")
        spec = FOUR_DBRX
        release()
        params, init_ms = timed(lambda: init_placed(cfg, 0, mesh))
        resident = torch.cuda.memory_allocated()
        eng = ServeEngine(cfg, params, max_len=spec["prompt_len"] + spec["max_new"], mesh=mesh)
        prompts = prompts_for(cfg, spec)
        eng.generate(prompts, spec["prompt_len"], 2)                    # warm
        _, one_ms = timed(lambda: eng.generate(prompts, spec["prompt_len"], 1))
        toks, all_ms = timed(lambda: eng.generate(prompts, spec["prompt_len"], spec["max_new"]))
        _, rec1 = count_collectives(lambda: eng.generate(prompts, spec["prompt_len"], 1))
        _, rec3 = count_collectives(lambda: eng.generate(prompts, spec["prompt_len"], 3))
        per_step = {}
        for op, nb, g in rec3:
            per_step.setdefault(op, [0, 0])
            per_step[op][0] += 1
            per_step[op][1] += nb
        for op, nb, g in rec1:
            per_step[op][0] -= 1
            per_step[op][1] -= nb
        out["dbrx"] = {"layers": cfg.num_layers, "mesh": list(mesh.shape),
                       "params_per_card_bytes": resident, "init_ms": init_ms,
                       "generate_1_ms": one_ms, "generate_ms": all_ms,
                       "decode_ms_per_step": (all_ms - one_ms) / (spec["max_new"] - 1),
                       "device_bytes_peak": torch.cuda.max_memory_allocated(),
                       "collectives_per_step": {op: {"count": c / 2, "bytes": b / 2}
                                                for op, (c, b) in per_step.items()},
                       "tokens": toks[0].tolist()}
        save()
        del eng, params
        release()

        # the same model at depth 2 on (1, 4) against one card (rank 0)
        cfg2 = dataclasses.replace(cfg, num_layers=FOUR_DBRX_SHORT_LAYERS)
        params = init_placed(cfg2, 0, mesh)
        eng = ServeEngine(cfg2, params, max_len=spec["prompt_len"] + spec["max_new"], mesh=mesh)
        toks_mesh = eng.generate(prompts, spec["prompt_len"], spec["max_new"])
        with torch.inference_mode(), use_sharding(mesh):
            tok = distribute(prompts, mesh, logical_to_spec(("batch", "seq"), prompts.shape, mesh))
            lg_mesh = full(make_prefill(cfg2, spec["prompt_len"] + 1)(params, tok)[0])
        del eng, params
        release()
        if rank == 0:
            one = transformer.init(0, cfg2, device="cuda")
            with torch.inference_mode():
                lg_one = make_prefill(cfg2, spec["prompt_len"] + 1)(one, prompts)[0]
            toks_one = ServeEngine(cfg2, one, max_len=spec["prompt_len"] + spec["max_new"],
                                   device="cuda").generate(prompts, spec["prompt_len"],
                                                           spec["max_new"])
            rel = float((lg_mesh.float() - lg_one.float()).norm() / lg_one.float().norm())
            out["dbrx_short"] = {"layers": cfg2.num_layers, "first_step_rel_l2": rel,
                                 "greedy_agreement": float((toks_mesh == toks_one).float().mean()),
                                 "first_token_equal": bool(torch.equal(toks_mesh[:, 0],
                                                                       toks_one[:, 0]))}
            del one
        save()
        dist.barrier()
        release()

    # (b) granite-8b on (1, 4), 36 layers: layer 0's sharded kernel 2 vs one card
    if "granite" in parts:
        cfg = get_config("granite_8b")
        pcfg = dataclasses.replace(cfg, psram_projections=True)
        params = init_placed(cfg, 0, mesh)
        l0 = params["blocks"][0]["layer0"]
        gen = torch.Generator(device="cuda").manual_seed(9)
        xs = {"wq": torch.randn((4, 128, cfg.d_model), generator=gen, device="cuda"),
              "wo": torch.randn((4, 128, cfg.q_dim), generator=gen, device="cuda"),
              "mlp_wo": torch.randn((4, 128, cfg.d_ff), generator=gen, device="cuda"),
              # decode rows: the slice that quantizes its own rows
              "wo_decode": torch.randn((4, 1, cfg.q_dim), generator=gen, device="cuda"),
              "mlp_wo_decode": torch.randn((4, 1, cfg.d_ff), generator=gen, device="cuda")}
        ws = {"wq": l0["mixer"]["wq"], "wo": l0["mixer"]["wo"], "mlp_wo": l0["mlp"]["wo"],
              "wo_decode": l0["mixer"]["wo"], "mlp_wo_decode": l0["mlp"]["wo"]}
        got, full_w = {}, {}
        zero()
        with torch.inference_mode(), use_sharding(mesh):
            for name, x in xs.items():
                x = x.to(torch.bfloat16)
                xp = distribute(x, mesh, logical_to_spec(("batch", "seq", None), x.shape, mesh))
                got[name] = full(_proj(xp, ws[name], pcfg))
                full_w[name] = full(ws[name])
        layer0_counts = counts()
        if rank == 0:
            with torch.inference_mode():
                out["granite_layer0"] = {
                    name: bool(torch.equal(got[name], _proj(xs[name].to(torch.bfloat16),
                                                            full_w[name], pcfg)))
                    for name in xs}
            out["granite_layer0_launches"] = layer0_counts
        del got, full_w
        gspec = FOUR_GRANITE
        gprompts = prompts_for(cfg, gspec)
        served = {}
        for name, c in (("exact", cfg), ("psram", pcfg)):
            eng = ServeEngine(c, params, max_len=gspec["prompt_len"] + gspec["max_new"], mesh=mesh)
            eng.generate(gprompts, gspec["prompt_len"], 2)
            zero()
            toks, ms = timed(lambda: eng.generate(gprompts, gspec["prompt_len"], gspec["max_new"]))
            launches = counts()
            _, one_ms = timed(lambda: eng.generate(gprompts, gspec["prompt_len"], 1))
            served[name] = {"generate_ms": ms, "launches": launches, "tokens": toks[0].tolist(),
                            "prefill_ms": one_ms,
                            "decode_step_ms": (ms - one_ms) / (gspec["max_new"] - 1)}
            del eng
        out["granite_serve"] = served
        save()
        del params, l0, ws
        release()

    # (c) granite-8b training, 36 layers, (4, 1), FSDP
    tmesh = make_host_mesh(model=1, device="cuda")
    tcfg = dataclasses.replace(get_config("granite_8b"), attention_impl="chunked", remat=True,
                               remat_policy="dots")
    dc = DataConfig(vocab_size=tcfg.vocab_size, **FOUR_TRAIN)
    oc = AdamWConfig(**TRAIN_OPT)
    if "train" in parts:
        tr, init_ms = timed(lambda: Trainer(tcfg, dc, opt_cfg=oc, mesh=tmesh, fsdp=True))
        resident = torch.cuda.memory_allocated()
        losses = tr.run(FOUR_TRAIN_STEPS, log_every=10 ** 9, log_fn=lambda *_: None)
        ms = [1e3 * t for t in tr.step_times]
        med = statistics.median(ms[2:])
        tokens = FOUR_TRAIN["global_batch"] * FOUR_TRAIN["seq_len"]
        out["train"] = {"layers": tcfg.num_layers, "mesh": list(tmesh.shape), "fsdp": tr.fsdp,
                        "losses": losses, "step_ms": ms, "step_ms_median": med,
                        "tokens_per_s": tokens / (med / 1e3), "init_ms": init_ms,
                        "state_per_card_bytes": resident,
                        "device_bytes_peak": torch.cuda.max_memory_allocated(),
                        "placement": str(tr.params["blocks"][0]["layer0"]["mixer"]["wq"]
                                         .placements)}
        save()
        del tr
        release()

    # (d) FOUR_CKPT_LAYERS layers in f32 on (4, 1) FSDP against one card,
    # then its 4-rank checkpoint restored on one card
    if "ckpt" in parts:
        ccfg = dataclasses.replace(tcfg, num_layers=FOUR_CKPT_LAYERS, dtype="float32")
        coc = AdamWConfig(**DIST_TRAIN_OPT)
        tr = Trainer(ccfg, dc, opt_cfg=coc, mesh=tmesh, fsdp=True)
        losses = tr.run(FOUR_CMP_STEPS, log_every=10 ** 9, log_fn=lambda *_: None)
        ckdir = tempfile.mkdtemp(prefix="four_card_ckpt_")
        CheckpointManager(ckdir).save(FOUR_CMP_STEPS, {"params": tr.params}, blocking=True)
        whole = tree_map(full, tr.params)
        master = tree_map(full, tr.opt_state["master"])
        if rank == 0:
            one = Trainer(ccfg, dc, opt_cfg=coc, device="cuda")
            want = one.run(FOUR_CMP_STEPS, log_every=10 ** 9, log_fn=lambda *_: None)
            out["train_short"] = {
                "layers": ccfg.num_layers, "dtype": ccfg.dtype, "opt": DIST_TRAIN_OPT,
                "losses": losses, "one_card_losses": want,
                "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(losses, want)),
                **master_drift(master, one.opt_state["master"], coc.lr * FOUR_CMP_STEPS)}
            del one
            like = {"params": tree_map(lambda t: torch.empty_like(t), whole)}
            got_ck, step = CheckpointManager(ckdir).restore(like)
            out["checkpoint"] = {"step": step, "layers": ccfg.num_layers,
                                 "bit_equal": all(torch.equal(a, b) for a, b in
                                                  zip(leaves(got_ck["params"]), leaves(whole))),
                                 "leaves": len(leaves(whole))}
        del tr, whole, master
        release()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def main_path_four_cards(torch, cfg, nnz: int, parts=FOUR_PARTS) -> dict:
    """The ``--cards 4`` run: four ranks, one a card (NCCL), spawned from
    here, record (a) dbrx-132b exact at full width and depth on (1, 4) —
    prefill and decode ms, params and peak bytes a card, the collectives of
    a decode step — and at depth 2 against one card (the first step's
    relative L2, greedy agreement); (b) granite-8b on (1, 4), 36 layers:
    layer 0's q (column-parallel), o and down (row-parallel: the int32-out
    route, the all-reduce, the epilogue launch) bit-equal to one card,
    served exact and pSRAM; (c) granite-8b trained at 36 layers on (4, 1)
    with FSDP; (d) granite-8b at depth 2 in f32 trained 2 steps on (4, 1)
    with FSDP against one card (the losses and the masters), and its 4-rank
    checkpoint restored on one card. Then in this
    process ``psram-mesh`` with 4 arrays on the 4 cards: bit-equal to
    ``psram-stream``, a sweep's ms, and whether a mesh call makes a host
    synchronize (``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch.multiprocessing as tmp

    out_dir = Path("chiprun_out") / "four_cards"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / "ranks.json"
    t0 = time.perf_counter()
    tmp.spawn(_four_card_rank, args=(free_port(), str(out_path), parts), nprocs=CARDS,
              join=True)
    phase = {"phase": "main_path_multicard", "cards": CARDS, "ranks_wall_s":
             time.perf_counter() - t0, **json.loads(out_path.read_text())}

    if "mesh" in parts:
        phase["psram_mesh"] = _four_card_mesh(torch, cfg, nnz)
    four_card_gates(phase)
    return phase


def _four_card_mesh(torch, cfg, nnz: int) -> dict:
    """``psram-mesh`` with 4 arrays over the 4 cards of this process."""
    from repro_torch import backends
    from repro_torch.core.cp_als import cp_als, init_factors
    from repro_torch.sparse import csf_for_mode, powerlaw_coo
    from repro_torch.sparse.mesh import mesh_stream_mttkrp
    from repro_torch.sparse.stream import stream_mttkrp

    coo = powerlaw_coo(0, NELL2_SHAPE, nnz=nnz, rank=8, alpha=1.1, device="cuda")
    csfs = [csf_for_mode(coo, m) for m in range(3)]
    init = init_factors(0, NELL2_SHAPE, RANK, device="cuda")
    fs = tuple(init)
    equal, call_ms = [], []
    for m in range(3):
        want = stream_mttkrp(csfs[m], fs, cfg, psram=True)
        got = mesh_stream_mttkrp(csfs[m], fs, cfg, n_arrays=CARDS, lowering="eager")
        equal.append(bool(torch.equal(got.to(want.device), want)))
        call_ms.append(time_ms(torch, lambda: mesh_stream_mttkrp(csfs[m], fs, cfg,
                                                                  n_arrays=CARDS,
                                                                  lowering="eager")))
    sync = "none"
    torch.cuda.set_sync_debug_mode("error")
    try:
        mesh_stream_mttkrp(csfs[0], fs, cfg, n_arrays=CARDS, lowering="eager")
    except RuntimeError as e:
        sync = str(e).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    mesh_cls = type(backends.get("psram-mesh", cfg))
    state, per_sweep = stamped_sweeps(torch, cp_als, mesh_cls, cfg, coo, csfs, init, SWEEPS,
                                      n_arrays=CARDS)
    out = {"arrays": CARDS, "cards": torch.cuda.device_count(),
           "bit_equal_to_psram_stream": equal, "call_ms": call_ms,
           "per_sweep_ms": per_sweep, "host_sync": sync}
    if not all(equal):
        raise AssertionError(f"psram-mesh on {CARDS} cards differs from psram-stream: {equal}")
    return out


def four_card_gates(phase: dict) -> None:
    """The four-card run's gates, on the parts it ran."""
    if "dbrx_short" in phase and phase["dbrx_short"]["first_step_rel_l2"] > FOUR_STEP_TOL:
        raise AssertionError(f"dbrx on (1, 4) vs one card: {phase['dbrx_short']}")
    if "granite_layer0" in phase and not all(phase["granite_layer0"].values()):
        raise AssertionError(f"granite-8b layer 0 on (1, 4) vs one card: {phase}")
    if "train" in phase:
        # main_path_train's gate, and below the untrained step-0 loss
        losses = phase["train"]["losses"]
        last5 = statistics.fmean(losses[-5:])
        if not (all(math.isfinite(x) for x in losses)
                and last5 < statistics.fmean(losses[:5]) - TRAIN_LOSS_DROP
                and last5 < losses[0]):
            raise AssertionError(f"the four-card training's losses: {losses}")
    if "train_short" in phase:
        # train_card_vs_cpu's tolerances: the loss 1e-5 relative; at most
        # 1e-3 of the master's elements beyond 1e-6 of their leaf's max, each
        # within 2 lr a step (Adam's first updates are about lr * sign(g))
        short = phase["train_short"]
        if not (short["loss_rel_err"] <= 1e-5 and short["master_worst_in_lr"] <= 2.0
                and short["master_beyond_1e6"] <= 1e-3 * short["master_elements"]):
            raise AssertionError(f"FSDP (4, 1) at depth {FOUR_CKPT_LAYERS} vs one card: {short}")
    if "checkpoint" in phase and not phase["checkpoint"]["bit_equal"]:
        raise AssertionError(f"the 4-rank checkpoint on one card: {phase['checkpoint']}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nnz", type=int, default=16_777_216,
                        help="requested samples of the synthetic tensor")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the whole report to this JSON file")
    parser.add_argument("--tuning", action="store_true",
                        help="also time kernel 2's decode route at every cluster size "
                             "and both routes over every M of the crossover sweep")
    parser.add_argument("--cards", type=int, default=1, choices=(1, CARDS),
                        help=f"{CARDS}: the four-card run alone (main_path_multicard over "
                             f"{CARDS} ranks, one a card); exits non-zero with fewer cards")
    parser.add_argument("--parts", default=",".join(FOUR_PARTS),
                        help=f"with --cards {CARDS}: which of {','.join(FOUR_PARTS)} to run")
    parser.add_argument("--split-only", action="store_true",
                        help="only kernel 2's K split after the build (split_cases with the "
                             "rows slice's layouts)")
    opts = parser.parse_args(argv)
    _LAST_EMIT[0] = _START[0] = time.perf_counter()

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from repro_torch import api, backends
    from repro_torch.backends import resolve_config
    from repro_torch.core.cp_als import cp_als, init_factors
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mttkrp import (
        drive_scales, mttkrp_fused, mttkrp_psram_fused, mttkrp_psram_strided,
        quantize_mttkrp_operands)
    from repro_torch.kernels.ordered_fold import ordered_fold
    from repro_torch.kernels.psram_matmul import (psram_adc_epilogue, psram_matmul,
                                                  psram_matmul_int32, psram_matmul_int32_rows)
    from repro_torch.kernels.segment_sum import blocked_segment_sum, padded_chain
    from repro_torch.kernels.stream_mttkrp import stream_mttkrp_fused
    from repro_torch.sparse import csf_for_mode, powerlaw_coo
    from repro_torch.sparse.stream import _chain_stream, _segment_blocks

    kernel_fns = {"stream_mttkrp_fused": stream_mttkrp_fused, "psram_matmul": psram_matmul,
                  "mttkrp_fused": mttkrp_fused, "mttkrp_psram_fused": mttkrp_psram_fused,
                  "mttkrp_psram_strided": mttkrp_psram_strided, "drive_scales": drive_scales,
                  "blocked_segment_sum": blocked_segment_sum,
                  "flash_attention": flash_attention, "ordered_fold": ordered_fold,
                  "psram_matmul_int32": psram_matmul_int32,
                  "psram_matmul_int32_rows": psram_matmul_int32_rows,
                  "psram_adc_epilogue": psram_adc_epilogue}

    def zero_counts():
        torch.cuda.synchronize()
        for fn in kernel_fns.values():
            fn.launches = 0
        for fn in routed:
            fn.routes = {route: 0 for route in fn.routes}

    routed = (psram_matmul, stream_mttkrp_fused, ordered_fold, mttkrp_psram_fused,
              mttkrp_psram_strided, blocked_segment_sum, psram_matmul_int32, flash_attention)

    def read_counts():
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in kernel_fns.items()}
        for fn in routed:
            counts.update({f"{fn.__name__}_{route}": n for route, n in fn.routes.items()})
        return counts

    report: dict = {}
    card = smi_line()

    # 1. device + build ----------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, path in libs.items() if path.with_suffix(".log").exists()}
    sass = sass_counts(libs)
    # kernel 6's instantiations: registers and spills (the bf16 consumers
    # run under setmaxnreg 240; D = 256 holds O 128 + S 32 + P 32 floats)
    flash_ptxas = ptxas_of("flash_attention", {
        "bf16_d128": "flash_bf16_kernelILi128E", "bf16_d256": "flash_bf16_kernelILi256E",
        "f32_d128": "flash_f32_kernelILi128E", "f32_d256": "flash_f32_kernelILi256E",
        "slab": "flash_slab_kernel"})
    report["device"] = {
        "phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "ptxas": ptxas, "flash_ptxas": flash_ptxas, "sass": sass,
        "sass_check": "flash_attention: wgmma + TMA only; psram_matmul: integer wgmma + TMA"
                      if sass is not None else "skipped, no cuobjdump beside nvcc",
    }
    emit(report["device"])
    # the bf16 flash kernel runs on wgmma fed by TMA; no mma.sync kernel is left
    if sass is not None:
        flash_sass = sass["flash_attention"]
        if not (flash_sass["HGMMA"] > 0 and flash_sass["UTMALDG"] > 0
                and flash_sass["HMMA"] == 0):
            raise AssertionError(f"flash_attention's SASS is not wgmma + TMA only: {flash_sass}")
        # kernel 2's wgmma route: integer warpgroup MMAs fed by TMA
        k2_sass = sass["psram_matmul"]
        if not (k2_sass["IGMMA"] > 0 and k2_sass["UTMALDG"] > 0):
            raise AssertionError(f"psram_matmul's SASS holds no integer wgmma or no TMA load: "
                                 f"{k2_sass}")

    if opts.split_only:
        split = split_cases(torch, tuning=True)
        emit({"phase": "split_only", **split})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if opts.cards == CARDS:
        # the four-card run: main_path_multicard over CARDS ranks, nothing else
        if torch.cuda.device_count() < CARDS:
            print(f"chip_smoke --cards {CARDS}: {torch.cuda.device_count()} CUDA device(s) "
                  f"visible, {CARDS} needed", file=sys.stderr)
            return 1
        four = main_path_four_cards(torch, resolve_config(None), opts.nnz,
                                    tuple(opts.parts.split(",")))
        report["main_path_multicard"] = four
        if opts.out is not None:
            opts.out.parent.mkdir(parents=True, exist_ok=True)
            opts.out.write_text(json.dumps(report, indent=1))
        emit(four)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # 2. data: host-side preprocessing --------------------------------------
    cfg = resolve_config(None)
    t0 = time.perf_counter()
    coo = powerlaw_coo(0, NELL2_SHAPE, nnz=opts.nnz, rank=8, alpha=1.1, device="cuda")
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csfs = [csf_for_mode(coo, m) for m in range(3)]
    csf_s = time.perf_counter() - t0
    init = init_factors(0, NELL2_SHAPE, RANK, device="cuda")
    t0 = time.perf_counter()
    xd = torch.randn(DENSE_SHAPE, generator=torch.Generator(device="cuda").manual_seed(5),
                     device="cuda")
    fd = init_factors(0, DENSE_SHAPE, RANK, device="cuda")
    torch.cuda.synchronize()
    report["data"] = {
        "phase": "data", "shape": list(NELL2_SHAPE), "nnz_requested": opts.nnz,
        "nnz": coo.nnz, "synth_s": synth_s, "csf_build_s": csf_s,
        "max_fiber": [int(c.fiber_lengths().max()) for c in csfs],
        "dense_shape": list(DENSE_SHAPE), "dense_bytes": nbytes(xd),
        "dense_synth_s": time.perf_counter() - t0,
    }
    emit(report["data"])

    # 3. kernels against their plain versions -------------------------------
    a_main = [stream_case(torch, csfs[m], tuple(init), cfg, cfg.adc.bits, timed=True)
              for m in range(3)]
    a_small = small_stream_cases(torch)
    if not any(len(c["routes_bit_equal"]) > 1 for c in a_small):
        raise AssertionError("no small stream case ran on both of kernel 1's routes")
    b_main = matmul_case(torch, *MLP_SHAPE, seed=1, timed=True)
    # the served prefill's four projection shapes (M = 8192), the ragged
    # head (the tile route) and the wgmma route's fill + epilogue alone
    b_prefill = [matmul_case(torch, *shape, seed=40 + i, timed=True)
                 for i, shape in enumerate(PREFILL_SHAPES)]
    b_ragged = matmul_case(torch, *RAGGED_SHAPE, seed=3, timed=True)
    b_epilogue = epilogue_case(torch, *EPILOGUE_SHAPE, seed=4)
    if b_main["route"] != "wgmma" or b_ragged["route"] != "tile" \
            or any(c["route"] != "wgmma" for c in b_prefill):
        raise AssertionError("kernel 2 took another route than its shapes name")
    # the served model's decode shapes: one row per prompt, every projection
    b_decode = [decode_case(torch, *shape, seed=6 + i, timed=True, tuning=opts.tuning)
                for i, shape in enumerate(DECODE_SHAPES)]
    b_decode_small = small_decode_cases(torch)
    b_crossover = crossover_sweep(torch, CROSSOVER_M if opts.tuning else CROSSOVER_M_DEFAULT)
    b_small = [matmul_case(torch, m, k, n, seed=2 + i, adc_bits=bits)
               for i, (m, k, n, bits) in enumerate([
                   (77, 1043, 131, 16),      # nothing a multiple of a tile; K odd
                   (5, 7, 3, 16),
                   (130, 64, 257, 8),
                   (16, 2048, 8, 16),        # accumulator beyond 2^24
                   (17, 4096, 1024, 16),     # the wgmma route: one row past decode,
                   (200, 1040, 144, 8),      # K and N multiples of 16 but not of a tile,
                   (257, 2064, 272, 24),     # ragged M
               ])]
    wgmma_small = [c for c in b_small if c["route"] == "wgmma"]
    d_main, p_main, s_main = [], [], []
    for mode in range(3):
        others = [d for d in range(3) if d != mode]
        x0 = xd.permute([mode] + others).reshape(DENSE_SHAPE[mode], -1).contiguous()
        b, c = fd[others[0]], fd[others[1]]
        d_main.append(dense_case(torch, x0, b, c, timed=True))
        q = quantize_mttkrp_operands(x0, b, c)
        del x0
        p_main.append(psram_case(torch, q, timed=True))
        # the same operands read in place from the tensor, as the dense
        # hopper call reads them
        s_main.append(strided_case(torch, xd.permute([mode] + others), q, timed=True))
        del q
    d_small, p_small = small_dense_cases(torch)
    s_small = small_strided_cases(torch)
    seg_main, chain_main, seg_host_s = [], [], []
    for mode in range(3):
        t0 = time.perf_counter()
        local, n_seg = _segment_blocks(csfs[mode], cfg.rows)[:2]
        coords = _chain_stream(csfs[mode])[0]
        seg_host_s.append(time.perf_counter() - t0)
        # the rows route's input: the exact chain over the padded stream
        chain = padded_chain(coords, csfs[mode].values, local, tuple(init), mode)
        # mode 0 (the longest fibers) is also held bit for bit at full size
        seg_main.append(segment_case(torch, chain, local, n_seg, timed=True,
                                     cpu_bit_check=mode == 0))
        chain_main.append(chain_segment_case(torch, csfs[mode], init, cfg, chain,
                                             cpu_bit_check=mode == 0))
        del chain
    seg_small = small_segment_cases(torch)
    # the ordered fold: the exact-fit MTTKRP of a hopper sweep (the last
    # mode) on its chain route and on the parent's stepped route, and the
    # skewed mode 0 (a 2.5 M-nonzero head row) through stream_mttkrp at full
    # size, against the CPU
    fold_main = fold_chunks_case(torch, csfs[2], init)
    fold_skew = stream_fold_check(torch, csfs[0], init)
    fold_small = small_fold_cases(torch)
    # the exact backend's sparse MTTKRP on every mode: the call and its one
    # chain-route launch
    fold_split = exact_sparse_split(torch, coo, init)
    # both chain routes' quantized variants (the psram-stream backend's):
    # every mode at full size against their plain versions' arithmetic,
    # timed beside the exact chain on the same route; small cases against
    # the CPU
    psram_main = [psram_route_case(torch, csfs[m], init, cfg, cfg.adc.bits) for m in range(3)]
    psram_small = small_psram_cases(torch)
    f_main = flash_case(torch, *FLASH_MAIN, torch.bfloat16, causal=True, seed=21, timed=True)
    # kernel 6 at Gemma-2-9B's D = 256 (bf16, softcap 50) and the slab
    # kernel at D = 512 (f32)
    f_d256 = flash_case(torch, *FLASH_D256, torch.bfloat16, causal=True,
                        softcap=FLASH_D256_SOFTCAP, seed=23, timed=True)
    f_d256["ptxas"] = flash_ptxas["bf16_d256"]
    f_slab = flash_case(torch, *FLASH_SLAB, torch.float32, causal=True, seed=24, timed=True)
    f_slab["ptxas"] = flash_ptxas["slab"]
    if f_d256["route"] != "wgmma" or f_slab["route"] != "slab":
        raise AssertionError("kernel 6 took another kernel than its head dims name")
    f_small = small_flash_cases(torch)
    # kernel 2 with saturate=False: the planted full-scale element unclipped
    b_unsat = [unsaturated_case(torch, *shape, seed=26 + i)
               for i, shape in enumerate(UNSAT_SHAPES)]
    report["kernel_cases"] = {
        "phase": "kernel_cases", "stream_main": a_main, "stream_small": a_small,
        "matmul_main": b_main, "matmul_prefill": b_prefill, "matmul_ragged": b_ragged,
        "matmul_epilogue": b_epilogue, "matmul_decode": b_decode, "matmul_small": b_small,
        "matmul_decode_small": b_decode_small, "matmul_crossover": b_crossover,
        "fold_main": fold_main, "fold_skew": fold_skew, "fold_small": fold_small,
        "exact_sparse_split": fold_split,
        "psram_main": psram_main, "psram_small": psram_small,
        "dense_main": d_main, "dense_small": d_small,
        "dense_psram_main": p_main, "dense_psram_small": p_small,
        "dense_strided_main": s_main, "dense_strided_small": s_small,
        "segment_main": seg_main, "segment_small": seg_small, "segment_chain_main": chain_main,
        "segment_host_s": seg_host_s,
        "flash_main": f_main, "flash_d256": f_d256, "flash_slab": f_slab,
        "flash_small": f_small, "matmul_unsaturated": b_unsat,
    }
    emit(report["kernel_cases"])

    # 4. main path ----------------------------------------------------------
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()

    t0 = time.perf_counter()
    hop = cp_als(None, RANK, n_iter=SWEEPS, sparse=coo, backend="hopper",
                 config=cfg, csfs=csfs, init=init)
    torch.cuda.synchronize()
    hop_s = time.perf_counter() - t0

    gen = torch.Generator(device="cuda").manual_seed(3)
    m, k, n = MLP_SHAPE
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    y = api.matmul(x, w, backend="hopper", config=cfg)
    w_head = torch.randn((k, RAGGED_SHAPE[2]), generator=gen, device="cuda") / k ** 0.5
    y_head = api.matmul(x, w_head, backend="hopper", config=cfg)
    torch.cuda.synchronize()

    launches = read_counts()

    t0 = time.perf_counter()
    exact = cp_als(None, RANK, n_iter=SWEEPS, sparse=coo, backend="exact",
                   csfs=csfs, init=init)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    y_exact = api.matmul(x, w, backend="exact")
    matmul_rel = float(torch.linalg.norm(y - y_exact) / torch.linalg.norm(y_exact))
    y_head_exact = api.matmul(x, w_head, backend="exact")
    head_rel = float(torch.linalg.norm(y_head - y_head_exact) / torch.linalg.norm(y_head_exact))

    main_path = {
        "phase": "main_path", "sweeps": SWEEPS, "rank": RANK,
        "fit_hopper": hop.fit, "fit_exact": exact.fit,
        "iters_hopper": hop.iters, "iters_exact": exact.iters,
        "cp_als_hopper_s": hop_s, "cp_als_exact_s": exact_s,
        "host_preprocessing_s": synth_s + csf_s,
        "device_bytes_held": held_before,
        "device_bytes_peak": torch.cuda.max_memory_allocated(),
        "matmul_shape": list(MLP_SHAPE), "matmul_rel_err": matmul_rel,
        "matmul_head_shape": list(RAGGED_SHAPE), "matmul_head_rel_err": head_rel,
        "launches": launches,
        "factors_on": sorted({str(f.device) for f in hop.factors}),
    }
    report["main_path"] = main_path
    emit(main_path)
    if not (math.isfinite(hop.fit) and math.isfinite(exact.fit)):
        raise AssertionError(f"non-finite fit: {main_path}")
    if abs(hop.fit - exact.fit) > 0.02:
        raise AssertionError(f"hopper fit strays from exact by more than 0.02: {main_path}")
    if launches["stream_mttkrp_fused"] < 3 * hop.iters or hop.iters != SWEEPS:
        raise AssertionError(f"the main path did not launch the stream kernel: {main_path}")
    if launches["stream_mttkrp_fused_chunk"] != launches["stream_mttkrp_fused"]:
        raise AssertionError(f"the main path's stream kernel left the chunk route: {main_path}")
    if launches["psram_matmul_wgmma"] < 1 or launches["psram_matmul_tile"] < 1:
        raise AssertionError(f"api.matmul did not launch kernel 2's wgmma route (MLP "
                             f"projection) and tile route (ragged head): {main_path}")
    if launches["ordered_fold_chain"] != hop.iters or launches["ordered_fold_fold"] != 0:
        raise AssertionError(f"the exact-fit MTTKRP did not run as one chain-route launch a "
                             f"sweep: {main_path}")
    if not all(f.is_cuda and torch.isfinite(f).all() for f in hop.factors) or not y.is_cuda:
        raise AssertionError("results are not finite tensors on the card")
    if tuple(y.shape) != (m, n) or not matmul_rel < 0.05:
        raise AssertionError(f"api.matmul strays from exact: rel {matmul_rel}")
    if tuple(y_head.shape) != (m, RAGGED_SHAPE[2]) or not head_rel < 0.05:
        raise AssertionError(f"api.matmul (ragged head) strays from exact: rel {head_rel}")

    # 4a'. main_path_fit: a tensor whose fit CP-ALS reaches, a gate that binds -
    fit_path, fit_launches = main_path_fit(torch, cfg, zero_counts, read_counts)
    report["main_path_fit"] = fit_path
    emit(fit_path)

    # 4b. the dense entry point, fused (int8 + ADC) and legacy (exact) --------
    del x, w, y, y_exact, w_head, y_head, y_head_exact
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    legacy = backends.get("hopper", cfg, compiled=False)
    zero_counts()
    t0 = time.perf_counter()
    dense_rel, legacy_rel = [], []
    for mode in range(3):
        want = api.mttkrp(xd, fd, mode, backend="exact")
        got = api.mttkrp(xd, fd, mode, backend="hopper", config=cfg)
        got_legacy = legacy.mttkrp(xd, fd, mode)
        for out in (got, got_legacy):
            if tuple(out.shape) != (DENSE_SHAPE[mode], RANK) or not out.is_cuda \
                    or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"dense MTTKRP of mode {mode}: shape {tuple(out.shape)}, "
                                     f"device {out.device}, or non-finite values")
        norm = torch.linalg.norm(want)
        dense_rel.append(float(torch.linalg.norm(got - want) / norm))
        legacy_rel.append(float(torch.linalg.norm(got_legacy - want) / norm))
    dense_launches = read_counts()
    dense_s = time.perf_counter() - t0
    dense_peak = torch.cuda.max_memory_allocated()
    # one whole call of each entry point per mode (unfolding copy, operand
    # quantization and the kernel), after the counted run
    api_ms = {
        "hopper": [time_ms(torch, lambda m=m: api.mttkrp(xd, fd, m, backend="hopper", config=cfg),
                           warmup=1, iters=3, reps=1) for m in range(3)],
        "hopper_legacy": [time_ms(torch, lambda m=m: legacy.mttkrp(xd, fd, m),
                                  warmup=1, iters=3, reps=1) for m in range(3)],
        "exact": [time_ms(torch, lambda m=m: api.mttkrp(xd, fd, m, backend="exact"),
                          warmup=1, iters=3, reps=1) for m in range(3)],
    }
    # one hopper call per mode split by operation, and the device memory
    # that call alone takes beyond what was held before it
    hopper_split, hopper_peak = [], []
    for m in range(3):
        def call(m=m):
            return api.mttkrp(xd, fd, m, backend="hopper", config=cfg)
        hopper_split.append(op_split(torch, call, r"mttkrp_\w+_kernel"))
        hopper_peak.append(call_bytes_peak(torch, call))
    dense_path = {
        "phase": "main_path_dense", "shape": list(DENSE_SHAPE), "rank": RANK,
        "rel_err_hopper": dense_rel, "rel_err_hopper_legacy": legacy_rel,
        "launches": dense_launches, "seconds": dense_s, "device_bytes_peak": dense_peak,
        "call_ms": api_ms, "hopper_split": hopper_split,
        "hopper_call_bytes_peak": hopper_peak,
    }
    report["main_path_dense"] = dense_path
    emit(dense_path)
    del xd, want, got, got_legacy
    if not max(dense_rel) < 0.05 or not max(legacy_rel) < 1e-5:
        raise AssertionError(f"dense MTTKRP strays from exact: {dense_path}")
    # the hopper call reads the tensor in place in every mode: one strided
    # launch a mode, none of the codes entry
    if dense_launches["mttkrp_psram_strided"] != 3 or dense_launches["drive_scales"] != 3 \
            or dense_launches["mttkrp_psram_fused"] != 0 or dense_launches["mttkrp_fused"] < 3:
        raise AssertionError(f"the dense path did not launch the dense kernels: {dense_path}")

    # 4c. CP-ALS on the legacy per-op path: the blocked segment-sum stream ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    leg = cp_als(None, RANK, n_iter=SWEEPS, sparse=coo, backend=legacy,
                 csfs=csfs, init=init)
    torch.cuda.synchronize()
    leg_s = time.perf_counter() - t0
    leg_launches = read_counts()
    leg_peak = torch.cuda.max_memory_allocated()
    # the blocked path folds its partials in order: the same bits twice
    from repro_torch.sparse.stream import stream_mttkrp_blocked

    leg_repeatable = all(
        torch.equal(stream_mttkrp_blocked(c, leg.factors, cfg),
                    stream_mttkrp_blocked(c, leg.factors, cfg)) for c in csfs)
    # one call a mode by operation, and its own peak memory
    leg_split = [legacy_split(torch, lambda c=c: stream_mttkrp_blocked(c, leg.factors, cfg))
                 for c in csfs]
    blocks = [_segment_blocks(c, cfg.rows) for c in csfs]
    # the fold route at the main path's shapes: each mode's partials read in
    # place, bit-equal to its plain version on the CPU and to the route
    # without order on the partials gathered first
    fold_route = [legacy_fold_case(torch, c, leg.factors, cfg) for c in csfs]
    legacy_path = {
        "phase": "main_path_legacy", "sweeps": SWEEPS, "rank": RANK,
        "fit_hopper_legacy": leg.fit, "fit_exact": exact.fit, "iters": leg.iters,
        "cp_als_s": leg_s, "launches": leg_launches, "blocked_repeatable": leg_repeatable,
        "n_seg": [bl[1] for bl in blocks],
        "partials_bytes": [bl[0].shape[0] * bl[1] * RANK * 4 for bl in blocks],
        "device_bytes_peak": leg_peak,
        "legacy_split": leg_split,
        "call_bytes_peak": [sp["call_bytes_peak"] for sp in leg_split],
        "fold_route": fold_route,
    }
    report["main_path_legacy"] = legacy_path
    emit(legacy_path)
    if not math.isfinite(leg.fit) or abs(leg.fit - exact.fit) >= 1e-4:
        raise AssertionError(f"legacy CP-ALS strays from exact: {legacy_path}")
    if leg_launches["blocked_segment_sum_chain"] != 3 * SWEEPS \
            or leg_launches["blocked_segment_sum_rows"] != 0 or leg.iters != SWEEPS:
        raise AssertionError(f"the legacy path did not launch the segment sum's chain route "
                             f"once a mode: {legacy_path}")
    if leg_launches["ordered_fold_fold"] != 3 * SWEEPS or not leg_repeatable \
            or not all(c["bit_equal_to_cpu"] and c["bit_equal_to_gathered"] for c in fold_route):
        raise AssertionError(f"the legacy path's partials were not folded in order, or not "
                             f"repeatably: {legacy_path}")
    # one fold launch a call, reading the partials in place: no index_select
    if any(sp["parts"]["fold"]["launches"] != 1 or sp["parts"]["index_select"]["launches"] != 0
           for sp in leg_split):
        raise AssertionError(f"a legacy call gathered its partials or did not fold them in one "
                             f"launch: {legacy_path}")
    if not all(f.is_cuda and torch.isfinite(f).all() for f in leg.factors):
        raise AssertionError("legacy CP-ALS factors are not finite tensors on the card")

    # 4c'. CP-ALS on the psram-stream backend, eager and compiled -----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    pst = cp_als(None, RANK, n_iter=SWEEPS, sparse=coo, backend="psram-stream", config=cfg,
                 csfs=csfs, init=init)
    torch.cuda.synchronize()
    pst_s = time.perf_counter() - t0
    pst_launches = read_counts()
    zero_counts()
    t0 = time.perf_counter()
    psc = cp_als(None, RANK, n_iter=SWEEPS, sparse=coo, backend="psram-stream", compiled=True,
                 config=cfg, csfs=csfs, init=init)
    torch.cuda.synchronize()
    psc_s = time.perf_counter() - t0
    psc_launches = read_counts()
    ps_peak = torch.cuda.max_memory_allocated()
    # each mode's MTTKRP through the api's default backend (psram-stream; the
    # per-mode CSF, so no host sort) and compiled, against exact; and the
    # device memory each call takes beside the (nnz, R) chain it never forms
    compiled_be = backends.get("psram-stream", cfg, compiled=True)
    fs_ps = tuple(pst.factors)
    ps_rel, psc_rel, ps_call_peak, psc_call_peak = [], [], [], []
    for m in range(3):
        want = api.mttkrp(csfs[m], fs_ps, m, backend="exact")
        got = api.mttkrp(csfs[m], fs_ps, m, config=cfg)
        got_c = compiled_be.mttkrp(csfs[m], fs_ps, m)
        for out in (got, got_c):
            if tuple(out.shape) != (NELL2_SHAPE[m], RANK) or not out.is_cuda \
                    or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"psram-stream MTTKRP of mode {m}: shape "
                                     f"{tuple(out.shape)}, device {out.device}, or non-finite")
        norm = torch.linalg.norm(want)
        ps_rel.append(float(torch.linalg.norm(got - want) / norm))
        psc_rel.append(float(torch.linalg.norm(got_c - want) / norm))
        del want, got, got_c
        ps_call_peak.append(call_bytes_peak(
            torch, lambda m=m: api.mttkrp(csfs[m], fs_ps, m, config=cfg)))
        psc_call_peak.append(call_bytes_peak(
            torch, lambda m=m: compiled_be.mttkrp(csfs[m], fs_ps, m)))
    rel_tol = compiled_be.capabilities().rel_tol
    psram_path = {
        "phase": "main_path_psram_stream", "sweeps": SWEEPS, "rank": RANK,
        "adc_bits": cfg.adc.bits, "rows": cfg.rows,
        "fit_psram_stream": pst.fit, "fit_psram_stream_compiled": psc.fit,
        "fit_exact": exact.fit, "iters": [pst.iters, psc.iters],
        "cp_als_s": pst_s, "cp_als_compiled_s": psc_s,
        "launches": pst_launches, "launches_compiled": psc_launches,
        "rel_err": ps_rel, "rel_err_compiled": psc_rel, "rel_tol": rel_tol,
        "call_bytes_peak": ps_call_peak, "call_bytes_peak_compiled": psc_call_peak,
        "chain_bytes": coo.nnz * RANK * 4, "device_bytes_peak": ps_peak,
    }
    report["main_path_psram_stream"] = psram_path
    emit(psram_path)
    if not (math.isfinite(pst.fit) and math.isfinite(psc.fit)) \
            or abs(pst.fit - psc.fit) > 1e-3:
        raise AssertionError(f"psram-stream CP-ALS: non-finite fits, or the eager and "
                             f"compiled fits more than 1e-3 apart: {psram_path}")
    if not max(ps_rel + psc_rel) < rel_tol:
        raise AssertionError(f"psram-stream MTTKRP strays from exact beyond its rel_tol: "
                             f"{psram_path}")
    # eager: one quantized chain-route launch a mode, the exact fit's chain
    # route once a sweep; compiled: kernel 5's quantized chain route and one
    # fold-route launch a mode
    if pst.iters != SWEEPS or psc.iters != SWEEPS \
            or pst_launches["ordered_fold_chain_psram"] != 3 * SWEEPS \
            or pst_launches["ordered_fold_chain"] != SWEEPS \
            or pst_launches["ordered_fold_fold"] != 0 or pst_launches["blocked_segment_sum"] != 0:
        raise AssertionError(f"the eager psram-stream path did not launch the ordered fold's "
                             f"quantized chain route once a mode: {psram_path}")
    if psc_launches["blocked_segment_sum_chain_psram"] != 3 * SWEEPS \
            or psc_launches["blocked_segment_sum"] != 3 * SWEEPS \
            or psc_launches["ordered_fold_fold"] != 3 * SWEEPS \
            or psc_launches["ordered_fold_chain"] != SWEEPS \
            or psc_launches["ordered_fold_chain_psram"] != 0:
        raise AssertionError(f"the compiled psram-stream path did not launch kernel 5's "
                             f"quantized chain route and the fold route once a mode: "
                             f"{psram_path}")
    if not max(ps_call_peak + psc_call_peak) < psram_path["chain_bytes"]:
        raise AssertionError(f"a psram-stream call took the memory of an (nnz, R) chain: "
                             f"{psram_path}")
    del pst, psc, fs_ps

    # 4c+. the autotune sweeps and the array mesh ----------------------------
    tune_path, tune_launches = main_path_autotune(torch, cfg, coo, csfs, init, zero_counts,
                                                  read_counts)
    report["main_path_autotune"] = tune_path
    emit(tune_path)
    mesh_path, mesh_launches = main_path_mesh(torch, cfg, coo, csfs, init, zero_counts,
                                              read_counts, psram_path["fit_psram_stream"])
    report["main_path_mesh"] = mesh_path
    emit(mesh_path)
    # 4c++. fault injection, ABFT and degraded mode on the card -------------
    faults_path, faults_launches = main_path_faults(torch, cfg, csfs, init, zero_counts,
                                                    read_counts)
    report["main_path_faults"] = faults_path
    emit(faults_path)

    # 4c''. the array's tile schedule: api.matmul's default, the dense
    # psram-scheduled MTTKRP, and the price --------------------------------
    from repro_torch.core.perf_model import (MTTKRPWorkload, h100_mttkrp_time_s, peak_petaops,
                                             stream_counts)
    from repro_torch.core.schedule import clear_program_cache, count_cycles
    from repro_torch.sparse.stream import stream_mttkrp_priced

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    xd = torch.randn(DENSE_SHAPE, generator=torch.Generator(device="cuda").manual_seed(5),
                     device="cuda")
    zero_counts()
    # where the phase's seconds go: each step's wall time on the host clock
    sched_s, t0 = {}, time.perf_counter()
    sched_main = [schedule_matmul_case(torch, *shape, cfg, seed=70 + i, split=i == 0)
                  for i, shape in enumerate((MLP_SHAPE, RAGGED_SHAPE))]
    torch.cuda.synchronize()
    sched_s["matmul"], t0 = time.perf_counter() - t0, time.perf_counter()
    sched_rel, sched_ms, sched_peak = [], [], []
    for mode in range(3):
        want = api.mttkrp(xd, fd, mode, backend="exact")
        got = api.mttkrp(xd, fd, mode, backend="psram-scheduled", config=cfg)
        if tuple(got.shape) != (DENSE_SHAPE[mode], RANK) or not got.is_cuda \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"psram-scheduled dense MTTKRP of mode {mode}: shape "
                                 f"{tuple(got.shape)}, device {got.device}, or non-finite")
        sched_rel.append(float(torch.linalg.norm(got - want) / torch.linalg.norm(want)))
        del want, got
        call = lambda m=mode: api.mttkrp(xd, fd, m, backend="psram-scheduled", config=cfg)
        sched_ms.append(time_ms(torch, call, warmup=1, iters=3, reps=1))
        sched_peak.append(call_bytes_peak(torch, call))
    sched_launches = read_counts()
    del xd
    sched_s["dense_mttkrp"], t0 = time.perf_counter() - t0, time.perf_counter()
    sched_cpu = schedule_cpu_cases(torch, cfg)
    clear_program_cache()                   # releases the captured graphs' pools
    sched_s["card_vs_cpu"], t0 = time.perf_counter() - t0, time.perf_counter()
    # the price: the §V headline on the analytical model and counted; each
    # mode of the sparse tensor priced on psram-stream from its CSF, equal
    # to the closed form and to the analytical model; mode 0 also from the
    # raw COO (describe builds that mode's CSF again on the host), equal
    paper = MTTKRPWorkload()
    headline = api.estimate(paper, config=cfg)
    counted = api.estimate(paper, backend="psram-scheduled", config=cfg)
    raw_coo_est = api.estimate(coo, backend="psram-stream", rank=RANK, mode=0, config=cfg)
    sched_s["price_raw_coo_mode0"], t0 = time.perf_counter() - t0, time.perf_counter()
    price_modes = []
    for m in range(3):
        est = api.estimate(csfs[m], backend="psram-stream", rank=RANK, mode=m, config=cfg)
        closed = stream_counts(cfg, csfs[m].fiber_lengths(), RANK)
        an = api.estimate(csfs[m], backend="analytical", rank=RANK, mode=m, config=cfg)
        others = [NELL2_SHAPE[d] for d in range(3) if d != m]
        roofline = h100_mttkrp_time_s(MTTKRPWorkload(i=NELL2_SHAPE[m], j=others[0], k=others[1],
                                                     rank=RANK, nnz=coo.nnz))
        price_modes.append({
            "mode": m, "counts": dataclasses.asdict(est.counts),
            "counts_equal_closed_form": est.counts == closed,
            "raw_coo_equal": same_price(est, raw_coo_est) if m == 0 else None,
            "breakdown_equal_analytical": est.breakdown == an.breakdown,
            "utilization": est.utilization, "sustained_petaops": est.sustained_petaops,
            "array_predicted_ms": 1e3 * est.time_s,
            "h100_psram_stream_measured_ms": time_ms(
                torch, lambda m=m: api.mttkrp(csfs[m], init, m, config=cfg),
                warmup=1, iters=3, reps=1),
            "h100_roofline_ms": 1e3 * roofline,
        })
    sched_s["price_per_mode"], t0 = time.perf_counter() - t0, time.perf_counter()
    # stream_mttkrp_priced runs the psram-stream eager path: one quantized
    # chain-route launch, counted; then held against that mode's call
    zero_counts()
    priced = stream_mttkrp_priced(csfs[2], tuple(init), cfg, psram=True,
                                  adc_bits=cfg.adc.bits)
    priced_launches = read_counts()
    priced_equal = bool(torch.equal(priced.result, api.mttkrp(csfs[2], init, 2, config=cfg)))
    priced_counts_equal = count_cycles(priced.program) \
        == stream_counts(cfg, csfs[2].fiber_lengths(), RANK)
    del priced
    sched_s["priced"] = time.perf_counter() - t0
    schedule_path = {
        "phase": "main_path_schedule", "config": dataclasses.asdict(cfg),
        "matmul": sched_main, "card_vs_cpu": sched_cpu,
        "hand_written_launches": "none: the scheduled matmul is plain PyTorch "
                                 "(torch.bmm + elementwise), every kernel count 0",
        "launches": sched_launches,
        "dense_mttkrp": {"shape": list(DENSE_SHAPE), "rank": RANK, "rel_err": sched_rel,
                         "call_ms": sched_ms, "call_bytes_peak": sched_peak},
        "device_bytes_peak": torch.cuda.max_memory_allocated(),
        "headline": {"peak_petaops": peak_petaops(cfg),
                     "analytical": dataclasses.asdict(headline.breakdown),
                     "psram_scheduled_counted": dataclasses.asdict(counted.breakdown),
                     "utilization": headline.utilization, "time_s": headline.time_s},
        "price_per_mode": price_modes,
        "price_labels": {"array_predicted_ms": "the pSRAM array's counted stream schedule "
                                               "(psram-stream cost), one array at 20 GHz",
                         "h100_psram_stream_measured_ms": "api.mttkrp on psram-stream, "
                                                          "measured on this card",
                         "h100_roofline_ms": "h100_mttkrp_time_s, int8 data sheet rates"},
        "priced": {"mode": 2, "result_bit_equal_to_psram_stream": priced_equal,
                   "program_counts_equal_closed_form": priced_counts_equal,
                   "launches": priced_launches},
        "step_s": sched_s,
    }
    report["main_path_schedule"] = schedule_path
    emit(schedule_path)
    if any(sched_launches.values()):
        raise AssertionError(f"the scheduled matmul launched a hand-written kernel: "
                             f"{schedule_path}")
    if not max(sched_rel) < backends.get("psram-scheduled").capabilities().rel_tol:
        raise AssertionError(f"psram-scheduled dense MTTKRP strays from exact: {schedule_path}")
    if round(peak_petaops(cfg), 6) != 17.03936 or headline.breakdown != counted.breakdown:
        raise AssertionError(f"the §V headline or its counted twin is off: {schedule_path}")
    if not all(p["counts_equal_closed_form"] and p["breakdown_equal_analytical"]
               and p["raw_coo_equal"] is not False for p in price_modes):
        raise AssertionError(f"psram-stream's counted price differs from the closed form or "
                             f"the analytical model: {schedule_path}")
    if not (priced_equal and priced_counts_equal) \
            or priced_launches["ordered_fold_chain_psram"] != 1:
        raise AssertionError(f"stream_mttkrp_priced is not the psram-stream call or its "
                             f"program is not the closed form: {schedule_path}")


    # 4d. the flash kernel's own entry point --------------------------------
    from repro_torch.kernels.ops import flash_attention_op
    from repro_torch.models import get_config, transformer
    from repro_torch.models.layers import _mask_bias, _proj, _sdpa, apply_rope, rmsnorm
    from repro_torch.serve import ServeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b, h, hkv, s, d = FLASH_MAIN
    gen = torch.Generator(device="cuda").manual_seed(22)
    fq = torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    fk = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    fv = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    zero_counts()
    t0 = time.perf_counter()
    fo = flash_attention_op(fq, fk, fv, causal=True)
    torch.cuda.synchronize()
    flash_s = time.perf_counter() - t0
    flash_launches = read_counts()
    flash_path = {
        "phase": "main_path_flash", "shape": list(FLASH_MAIN), "dtype": "bfloat16",
        "seconds": flash_s, "finite": bool(torch.isfinite(fo).all()),
        "out_shape": list(fo.shape), "launches": flash_launches,
    }
    del fq, fk, fv, fo
    if not flash_path["finite"] or flash_launches["flash_attention"] < 1:
        raise AssertionError(f"flash_attention_op did not run the kernel: {flash_path}")

    # 4d'. the same entry point at Gemma-2-9B's attention (D = 256, bf16,
    # softcap 50) and at D = 512 (the slab kernel, f32) ----------------------
    torch.cuda.synchronize()
    wide_in = []
    for i, (shape, dtype) in enumerate(((FLASH_D256, torch.bfloat16),
                                        (FLASH_SLAB, torch.float32))):
        gen = torch.Generator(device="cuda").manual_seed(27 + i)
        wide_in.append([torch.randn((shape[0], heads, shape[3], shape[4]), generator=gen,
                                    device="cuda", dtype=dtype)
                        for heads in (shape[1], shape[2], shape[2])])
    zero_counts()
    t0 = time.perf_counter()
    wide_out = [flash_attention_op(*wide_in[0], causal=True, softcap=FLASH_D256_SOFTCAP),
                flash_attention_op(*wide_in[1], causal=True)]
    torch.cuda.synchronize()
    flash_wide_s = time.perf_counter() - t0
    flash_wide_launches = read_counts()
    flash_wide = {
        "phase": "main_path_flash_wide", "shapes": [list(FLASH_D256), list(FLASH_SLAB)],
        "dtypes": ["bfloat16", "float32"], "softcap": [FLASH_D256_SOFTCAP, 0.0],
        "seconds": flash_wide_s, "launches": flash_wide_launches,
        "finite": all(bool(torch.isfinite(o).all()) for o in wide_out),
        "out_shapes": [list(o.shape) for o in wide_out],
    }
    del wide_in, wide_out
    report["main_path_flash_wide"] = flash_wide
    emit(flash_wide)
    if not (flash_wide["finite"] and flash_wide_launches["flash_attention_wgmma"] == 1
            and flash_wide_launches["flash_attention_slab"] == 1):
        raise AssertionError(f"flash_attention_op at D = 256 / 512 did not run kernel 6's "
                             f"bf16 and slab kernels once each: {flash_wide}")

    # 4e. serving granite-8b, exact and pSRAM projections -----------------
    scfg = get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sparams = transformer.init(7, scfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = seeded_prompts(torch, scfg, SERVE_BATCH, SERVE_PROMPT, 8)
    exact_run, exact_launches, exact_logits, _, _ = serve_run(
        torch, scfg, sparams, prompts, ServeEngine, zero_counts, read_counts)

    # the flash kernel against the served model's own attention: layer 0's
    # post-RoPE q/k/v of the prompts, (B, S, H, D) for the model, (B, H, S, D)
    # for the kernel; the reference's bf16 tolerance for its kernel, 3e-2
    with torch.inference_mode():
        p0 = sparams["blocks"][0]["layer0"]
        x0 = rmsnorm(p0["pre_norm"], sparams["embed"][prompts], scfg.norm_eps)
        pos = torch.arange(SERVE_PROMPT, device="cuda", dtype=torch.int32).expand(SERVE_BATCH, -1)
        shp = (SERVE_BATCH, SERVE_PROMPT)
        q0 = apply_rope(_proj(x0, p0["mixer"]["wq"], scfg).reshape(*shp, scfg.n_heads, -1), pos, scfg)
        k0 = apply_rope(_proj(x0, p0["mixer"]["wk"], scfg).reshape(*shp, scfg.n_kv_heads, -1),
                        pos, scfg)
        v0 = _proj(x0, p0["mixer"]["wv"], scfg).reshape(*shp, scfg.n_kv_heads, -1)
        idx = torch.arange(SERVE_PROMPT, device="cuda")
        model_attn = _sdpa(q0, k0, v0, _mask_bias(idx[:, None], idx[None, :], True, 0), scfg)
        qkv = [t.transpose(1, 2).contiguous() for t in (q0, k0, v0)]
        zero_counts()
        flash_attn = flash_attention_op(*qkv, causal=True).transpose(1, 2)
        served_counts = read_counts()
        for key in ("flash_attention", *(f"flash_attention_{r}" for r in flash_attention.routes)):
            flash_launches[key] += served_counts[key]
        attn_diff = (flash_attn.float() - model_attn.float()).abs()
        attn_ok = bool((attn_diff <= 3e-2 + 3e-2 * model_attn.float().abs()).all())
        # and the kernel against its plain version on the same served q/k/v,
        # at the one-ulp envelope of the seeded cases (raises if outside)
        _, served_vs_plain = flash_check(torch, *qkv, causal=True)
        flash_path["served_layer0"] = {
            "shape": [SERVE_BATCH, scfg.n_heads, SERVE_PROMPT, scfg.head_dim],
            "max_abs_err": float(attn_diff.max()), "within_3e-2": attn_ok,
            "vs_plain": served_vs_plain}
        del x0, q0, k0, v0, qkv, model_attn, flash_attn, attn_diff
    report["main_path_flash"] = flash_path
    emit(flash_path)
    if not attn_ok:
        raise AssertionError(f"flash_attention_op strays from the served model's attention: "
                             f"{flash_path}")

    exact_peak = torch.cuda.max_memory_allocated()
    # the write-through decode (blocks.group_decode) on the served model's group 0
    decode_write = {"phase": "group_decode", **group_decode_case(torch, scfg, sparams)}
    report["group_decode"] = decode_write
    emit(decode_write)
    del sparams
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pcfg = dataclasses.replace(scfg, psram_projections=True, psram_stored_int8=True)
    pparams = transformer.init(9, pcfg, device="cuda")
    int8_bytes = int8_word_bytes(pparams)
    psram_run, psram_launches, psram_logits, peng, ptoks = serve_run(
        torch, pcfg, pparams, prompts, ServeEngine, zero_counts, read_counts)
    # the first TOKENS_CHECKED greedy tokens again, every decode projection
    # also computed on the tile route and held bit-equal: what the tile
    # route would have served, and the same tokens
    psram_run["decode_route_vs_tile_route"] = routes_agree(torch, peng, prompts, ptoks)
    del peng, ptoks
    n_proj = 7 * scfg.num_layers                      # wq, wk, wv, wo, wi, wg, wo
    served_matmul = served_matmul_cases(
        torch, engine_stages(torch, ServeEngine(pcfg, pparams, max_len=SERVE_PROMPT + SERVE_NEW,
                                                device="cuda"), pparams, prompts),
        [pparams["blocks"][0]], ({"wgmma": 7}, {"decode": 7}),
        ({"wgmma": n_proj}, {"decode": n_proj}))
    # the same prompts through an exact model whose weights are the array's
    # words dequantized (q * scale, rounded to bf16)
    psram_vs_deq = psram_vs_dequantized(torch, transformer, pparams, (), prompts, scfg,
                                        psram_logits)
    serve_path = {
        "phase": "main_path_serve", "arch": SERVE_ARCH, "layers": scfg.num_layers,
        "params": scfg.param_count(), "dtype": scfg.dtype, "init_s": init_s,
        "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT, "max_new": SERVE_NEW,
        "exact": {**exact_run, "launches": exact_launches, "device_bytes_peak": exact_peak},
        "psram": {**psram_run, "launches": psram_launches, "int8_weight_bytes": int8_bytes,
                  "prefill_vs_dequantized_rel_l2": psram_vs_deq,
                  "layer0_matmul_vs_plain": served_matmul,
                  "device_bytes_peak": torch.cuda.max_memory_allocated()},
        "psram_launches_per_forward": psram_launches["psram_matmul"] / (1 + SERVE_NEW),
    }
    report["main_path_serve"] = serve_path
    emit(serve_path)
    del pparams, psram_logits, exact_logits
    torch.cuda.empty_cache()
    # kernel 2 on every projection: the wgmma route in the prefill, the
    # decode route in a step
    check_served("granite-8b", serve_path,
                 {"wgmma": n_proj, "tile": 0, "decode": n_proj * SERVE_NEW})
    prefill_k2 = psram_run["prefill_profile"]["kernel2_launches"]
    if prefill_k2 != 7 * scfg.num_layers:
        raise AssertionError(f"the profiled pSRAM prefill launched kernel 2 {prefill_k2} "
                             f"times, not {7 * scfg.num_layers}: {serve_path}")
    if psram_run["decode_profile"]["kernel_launches_per_step"] > PSRAM_DECODE_LAUNCH_CEILING:
        raise AssertionError(f"a pSRAM decode step launches more than "
                             f"{PSRAM_DECODE_LAUNCH_CEILING} kernels: {serve_path}")

    # 4e'. the MoE family served: granite-moe-1b-a400m, exact and pSRAM -----
    moe_path, moe_exact_launches, moe_psram_launches = main_path_moe(torch, zero_counts,
                                                                     read_counts)
    report["main_path_moe"] = moe_path
    emit(moe_path)

    # 4e''. the SSM, encoder-decoder and M-RoPE families served -------------
    ssm_path, ssm_exact_launches, ssm_psram_launches = main_path_ssm(torch, zero_counts,
                                                                     read_counts)
    report["main_path_ssm"] = ssm_path
    emit(ssm_path)
    encdec_path, encdec_exact_launches, encdec_psram_launches = main_path_encdec(
        torch, zero_counts, read_counts)
    report["main_path_encdec"] = encdec_path
    emit(encdec_path)
    mrope_path, mrope_launches = main_path_mrope(torch, zero_counts, read_counts)
    report["main_path_mrope"] = mrope_path
    emit(mrope_path)

    # 4e+. the paged serve loop: granite-8b on a live stream ----------------
    paged_path, paged_exact_launches, paged_psram_launches, paged_pressure_launches, \
        paged_matmul = main_path_paged(torch, zero_counts, read_counts)
    report["main_path_paged"] = paged_path
    emit(paged_path)

    # per-sweep time, warm: cp_als sorts and merges duplicates on the host
    # before its first sweep, so a sweep is timed on its own — a backend
    # instance that stamps the clock (after a synchronize) whenever mode 0 is
    # asked for marks each sweep's start; the fit of sweep i ends before the
    # stamp of sweep i+1. Untraced: type(backends.get(...)) is the backend's
    # own class only while tracing is off
    def sweep_ms(name, sweeps=SWEEPS, **kwargs):
        stamps = []

        class Stamped(type(backends.get(name, cfg))):
            def mttkrp(self, data, factors, mode):
                if mode == 0:
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
                return super().mttkrp(data, factors, mode)

        cp_als(None, RANK, n_iter=sweeps + 1, sparse=coo, backend=Stamped(cfg, **kwargs),
               csfs=csfs, init=init, tol=0)
        return [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]

    # 4f. main_path_trace: repro_torch.obs on the card ----------------------
    trace_path = main_path_trace(torch, cfg, coo, csfs, init, fd, zero_counts, read_counts,
                                 sweep_ms)
    report["main_path_trace"] = trace_path
    emit(trace_path)

    sweeps = {name: sweep_ms(name) for name in ("hopper", "exact")}
    sweeps["hopper_legacy"] = sweep_ms("hopper", compiled=False)
    sweeps["psram_stream"] = sweep_ms("psram-stream")
    sweeps["psram_stream_compiled"] = sweep_ms("psram-stream", compiled=True)

    # what a hopper sweep holds besides its three kernel-A launches, each
    # piece timed alone at the sweep's shapes (plain PyTorch, all of it)
    from repro_torch.kernels.stream_mttkrp import quantize_stream_factors
    from repro_torch.sparse.stream import stream_mttkrp, stream_mttkrp_blocked

    fs = tuple(hop.factors)
    gram = fs[0].T @ fs[0]
    sweep_parts_ms = {
        "exact_fit_mttkrp_last_mode": time_ms(
            torch, lambda: stream_mttkrp(csfs[-1], fs), iters=3, reps=1),
        "quantize_factors_3_modes": time_ms(
            torch, lambda: [quantize_stream_factors(fs, mode) for mode in range(3)]),
        "pinv_3_modes": time_ms(
            torch, lambda: [torch.linalg.pinv(gram) for _ in range(3)]),
        # one mode of a legacy sweep: kernel 5's chain route + the partials' ordered fold
        "legacy_mttkrp_per_mode": [time_ms(
            torch, lambda m=m: stream_mttkrp_blocked(csfs[m], fs, cfg), iters=3, reps=1)
            for m in range(3)],
    }
    report["sweep_time"] = {
        "phase": "sweep_time",
        "per_sweep_ms_hopper": statistics.median(sweeps["hopper"]),
        "per_sweep_ms_exact": statistics.median(sweeps["exact"]),
        "per_sweep_ms_hopper_legacy": statistics.median(sweeps["hopper_legacy"]),
        "per_sweep_ms_psram_stream": statistics.median(sweeps["psram_stream"]),
        "per_sweep_ms_psram_stream_compiled": statistics.median(sweeps["psram_stream_compiled"]),
        "sweeps_ms": sweeps,
        # the same backends' sweeps split in place by the tracer (medians of
        # main_path_trace's traced runs)
        "traced_split_ms": {key: r["median"] for key, r in trace_path["runs"].items()},
        "sweep_parts_ms": sweep_parts_ms,
        "before_first_sweep_s": hop_s - 1e-3 * SWEEPS * statistics.median(sweeps["hopper"]),
    }
    emit(report["sweep_time"])

    # 6. main_path_train: granite-8b at full width trained on the card -----
    train_path, train_launches, train_profile_launches, train_ef_launches = main_path_train(
        torch, zero_counts, read_counts)
    report["main_path_train"] = train_path
    emit(train_path)

    # 7. main_path_dist: sharding, the model meshes and the dry run --------
    dist_path, dist_a_launches, dist_b_launches, dist_serve_launches = main_path_dist(
        torch, cfg, csfs[0], zero_counts, read_counts)
    report["main_path_dist"] = dist_path
    emit(dist_path)

    # 8. main_path_examples: every example of repro_torch.examples ----------
    examples_path, examples_launches = main_path_examples(torch, zero_counts, read_counts)
    report["main_path_examples"] = examples_path
    emit(examples_path)

    # 9. main_path_multicard: DTensors on a world-size-1 NCCL group ---------
    multi_path, multi_launches = main_path_multicard(torch, zero_counts, read_counts,
                                                     opts.tuning)
    report["main_path_multicard"] = multi_path
    emit(multi_path)

    # the contract's kernel table -------------------------------------------
    def mean(key, cases=a_main):
        return statistics.fmean(c[key] for c in cases)

    f_served = flash_path["served_layer0"]["vs_plain"]
    main_paths = (launches, dense_launches, leg_launches, pst_launches, psc_launches,
                  tune_launches, mesh_launches, faults_launches, sched_launches,
                  priced_launches, flash_launches, flash_wide_launches, exact_launches,
                  psram_launches,
                  moe_exact_launches, moe_psram_launches, ssm_exact_launches,
                  ssm_psram_launches, encdec_exact_launches, encdec_psram_launches,
                  mrope_launches, paged_exact_launches, paged_psram_launches,
                  paged_pressure_launches, train_launches, train_ef_launches,
                  dist_a_launches, dist_b_launches, dist_serve_launches, fit_launches,
                  *examples_launches, multi_launches)

    def total(name):
        return sum(counts.get(name, 0) for counts in main_paths)

    split_list = multi_path["split_k"]

    def split_row(route):
        cs = [c for c in split_list if c["route"] == route]
        main = cs[-1]                             # down's K at this route's rows
        return {
            "name": f"psram_matmul_int32_{route}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu (the "
                      + {"wgmma": "psram_matmul_wgmma_kernel", "tile": "psram_matmul_kernel",
                         "decode": "psram_matmul_decode_kernel"}[route]
                      + "<..., RAW = true>: the route's int32 sums of one K slice, its "
                        "epilogue compiled out; a row-parallel pSRAM projection on a mesh)",
            "replaces": "src/repro/kernels/psram_matmul.py:80",
            "launches": total(f"psram_matmul_int32_{route}"),
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": main["library"], "shape": main["shape"], "ways": SPLIT_WAYS,
            "tolerance": f"{SPLIT_WAYS} K slices' int32 sums added + the epilogue launch "
                         "bit-equal to the fused kernel on the whole K; each slice's sums "
                         "equal to the plain integer product",
            "per_shape": [{k: c[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                             "library_ms")} for c in cs],
        }

    def rows_row():
        cs = [c for c in split_list if c["route"] == "decode"]
        main = cs[-1]["rows"]                     # down's K slice
        return {
            "name": "psram_matmul_int32_rows", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu (psram_matmul_rows_kernel: "
                      "the decode kernel's int32 sums of one K slice, its B words quantized "
                      "in registers from the f32 / bf16 rows; a row-parallel projection's "
                      "decode rows)",
            "replaces": "src/repro/kernels/psram_matmul.py:80 (with quantize_symmetric's "
                        "codes, src/repro/core/quantization.py:55)",
            "launches": total("psram_matmul_int32_rows"),
            "max_abs_err": max(c["rows"][d]["max_abs_err"] for c in cs for d in ("f32", "bf16")),
            # ms: device time in a CUDA graph, plain_ms: CUDA events over
            # eager calls; each with its other timing beside it
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "eager_ms",
                                    "plain_device_ms")},
            "library_ms": None,
            "library": "none (no one PyTorch call quantizes rows and multiplies in int8)",
            "shape": [cs[-1]["shape"][0], cs[-1]["shape"][1] // SPLIT_WAYS, cs[-1]["shape"][2]],
            "tolerance": "each slice's int32 sums equal to its plain version (the quantization "
                         "ops + the int32 decode route); the K split + the epilogue bit-equal "
                         "to the fused kernel on the whole K",
            "per_shape": [{"shape": c["shape"], **{k: c["rows"][k] for k in (
                "ms", "eager_ms", "plain_ms", "plain_device_ms", "bound_ms")}} for c in cs],
        }

    def row(name, source, replaces, main, small, tolerance, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": total(name),
            "max_abs_err": max(c["max_abs_err"] for c in main + small),
            "ms": mean("ms", main), "plain_ms": mean("plain_ms", main),
            "bound_ms": mean("bound_ms", main), "bound_by": main[0]["bound_by"],
            "library_ms": mean("library_ms", main), "tolerance": tolerance,
            "per_mode_ms": [c["ms"] for c in main], **extra,
        }

    kernels = {"kernels": [
        {
            "name": "stream_mttkrp_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/stream_mttkrp.cu",
            "replaces": "src/repro/kernels/stream_mttkrp.py:173",
            "launches": total("stream_mttkrp_fused"),
            "max_abs_err": max(c["max_abs_err"] for c in a_main + a_small),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": a_main[0]["bound_by"], "library_ms": None,
            "tolerance": "per element: one ADC code (2*chunk full scale/2^16) per "
                         "segment of the row + 1e-6 of the full scales; bit-equal "
                         "to the stream-ordered plain version on the small cases, "
                         "on every route that can take them; the routes bit-equal "
                         "to each other at full size",
            "per_mode_ms": [c["ms"] for c in a_main],
            "routes": {r: {"launches": total(f"stream_mttkrp_fused_{r}"),
                           "per_mode_ms": [c["routes"].get(r, {}).get("ms") for c in a_main]}
                       for r in stream_mttkrp_fused.routes},
            "passes_ms": [c["passes_ms"] for c in a_main],
            "autotune": {"launches": tune_launches["stream_mttkrp_fused"],
                         "trials": sum(len(sw["trials"])
                                       for sw in tune_path["autotune_sweeps"]),
                         "winners": tune_path["winners"]},
            "mesh_launches": mesh_launches["stream_mttkrp_fused"],
        },
        {
            "name": "psram_matmul_wgmma", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu (psram_matmul_wgmma_kernel: "
                      "the wgmma route, M > M_DECODE, operands TMA can take)",
            "replaces": "src/repro/kernels/psram_matmul.py:80",
            "launches": total("psram_matmul_wgmma"),
            "max_abs_err": max(c["max_abs_err"] for c in [b_main] + b_prefill + wgmma_small
                               + [c for c in served_matmul + paged_matmul
                                  if c["route"] == "wgmma"]),
            "ms": b_main["ms"], "plain_ms": b_main["plain_ms"],
            "bound_ms": b_main["bound_ms"], "bound_by": b_main["bound_by"],
            "library_ms": b_main["library_ms"],
            "library": "torch._int_mm + ADC",
            "tolerance": "bit-equal to the plain version and to the tile route (seeded "
                         "shapes, the prefill's four shapes at M = 8192, and the served "
                         "model's layer-0 operands in a prefill); bit-equal to the plain "
                         "version on the paged loop's layer-0 prefill at bucket 128",
            "shape": b_main["shape"], "tile_ms": b_main["tile_ms"],
            "per_shape": [{k: c[k] for k in ("shape", "ms", "tile_ms", "bound_ms", "plain_ms",
                                             "library_ms", "tops")}
                          for c in [b_main] + b_prefill],
            "epilogue": b_epilogue,
            "unsaturated": [c for c in b_unsat if c["route"] == "wgmma"],
        },
        {
            "name": "psram_matmul_tile", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu (psram_matmul_kernel: "
                      "the tile route, M > M_DECODE, operands TMA cannot take)",
            "replaces": "src/repro/kernels/psram_matmul.py:80",
            "launches": total("psram_matmul_tile"),
            "max_abs_err": max(c["max_abs_err"] for c in [b_ragged] + b_small
                               if c["route"] == "tile"),
            "ms": b_ragged["ms"], "plain_ms": b_ragged["plain_ms"],
            "bound_ms": b_ragged["bound_ms"], "bound_by": b_ragged["bound_by"],
            "library_ms": b_ragged["library_ms"],
            "library": "torch._int_mm + ADC",
            "tolerance": "bit-equal (seeded shapes; the wgmma route's shapes and served "
                         "operands also against it)",
            "graph_ms": b_ragged["graph_ms"], "library_graph_ms": b_ragged["library_graph_ms"],
            "shape": b_ragged["shape"], "split": b_ragged["split"],
            "split_ms": b_ragged["split_ms"], "ms_at_mlp_shape": b_main["tile_ms"],
            "ms_at_prefill_shapes": [c["tile_ms"] for c in b_prefill],
        },
        {
            "name": "psram_matmul_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu (psram_matmul_decode_kernel: "
                      "the decode route, M <= M_DECODE)",
            "replaces": "src/repro/kernels/psram_matmul.py:80",
            "launches": total("psram_matmul_decode"),
            "max_abs_err": max(c["max_abs_err"] for c in b_decode + b_decode_small
                               + [c for c in served_matmul + paged_matmul
                                  if c["route"] == "decode"]),
            "ms": b_decode[2]["ms"], "plain_ms": b_decode[2]["plain_ms"],
            "bound_ms": b_decode[2]["bound_ms"], "bound_by": b_decode[2]["bound_by"],
            "library_ms": b_decode[2]["library_ms"], "library": b_decode[2]["library"],
            "tolerance": "bit-equal to the plain version and to the tile route (seeded "
                         "shapes, every cluster size, and the served model's layer-0 "
                         "operands in a decode step); bit-equal to the plain version on the "
                         "paged loop's layer-0 prefill at bucket 8 and decode step",
            "shape": b_decode[2]["shape"], "tile_ms": b_decode[2]["tile_ms"],
            "per_shape": [{k: c[k] for k in ("shape", "cluster", "ms", "tile_ms", "bound_ms",
                                             "library_ms")} for c in b_decode],
            "unsaturated": [c for c in b_unsat if c["route"] == "decode"],
        },
        row("mttkrp_fused", "src/repro_torch/kernels/csrc/mttkrp.cu",
            "src/repro/kernels/mttkrp.py:54", d_main, d_small,
            "allclose rtol 2e-4, atol 2e-4 * max|plain|",
            max_rel_err=max(c["max_rel_err"] for c in d_main + d_small),
            max_err_over_max=max(c["max_err_over_max"] for c in d_main + d_small)),
        {
            "name": "mttkrp_psram_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mttkrp.cu (mttkrp_psram_ring_kernel: the "
                      "f32 front ends reading the tensor in place, the main path, and the "
                      "codes front end; mttkrp_rowmax_*_kernel: the row scales; "
                      "mttkrp_partials_kernel<true, *>: codes TMA cannot take)",
            "replaces": "src/repro/kernels/mttkrp.py:121",
            "launches": total("mttkrp_psram_strided") + total("mttkrp_psram_fused"),
            "max_abs_err": max(c["max_abs_err"] for c in s_main + s_small + p_main + p_small),
            "ms": mean("ms", s_main), "plain_ms": mean("plain_ms", s_main),
            "bound_ms": mean("bound_ms", s_main), "bound_by": s_main[0]["bound_by"],
            "library_ms": None,
            "library": "none (no one PyTorch call quantizes and contracts; the codes "
                       "front end's (qx.float()*sx) @ kr + ADC in fronts.codes)",
            "tolerance": "per element: 2 ADC codes of its 128-row tile's full scale + rtol "
                         "2e-4 of the plain version; the f32 front end's codes and scales "
                         "equal to quantize_symmetric's, its output bit-equal to the codes "
                         "front end where both cut the same stages (every main-path mode)",
            "per_mode_ms": [c["ms"] for c in s_main],
            "fronts": {
                "f32": {"launches": total("mttkrp_psram_strided"),
                        "routes": {r: total(f"mttkrp_psram_strided_{r}")
                                   for r in mttkrp_psram_strided.routes},
                        "ms": mean("ms", s_main), "bound_ms": mean("bound_ms", s_main),
                        "ring_ms": [c["ring_ms"] for c in s_main],
                        "max_err_in_codes": max(c["max_err_in_codes"]
                                                for c in s_main + s_small)},
                "rowmax": {"launches": total("drive_scales"), "ms": mean("rowmax_ms", s_main),
                           "per_mode_ms": [c["rowmax_ms"] for c in s_main],
                           "bound_ms": mean("rowmax_bound_ms", s_main), "bound_by": "bytes"},
                "codes": {"launches": total("mttkrp_psram_fused"),
                          "routes": {r: total(f"mttkrp_psram_fused_{r}")
                                     for r in mttkrp_psram_fused.routes},
                          "ms": mean("ms", p_main), "per_mode_ms": [c["ms"] for c in p_main],
                          "partials_ms": [c["codes_partials_ms"] for c in s_main],
                          "bound_ms": mean("bound_ms", p_main),
                          "bound_by": p_main[0]["bound_by"],
                          "plain_ms": mean("plain_ms", p_main),
                          "library_ms": mean("library_ms", p_main),
                          "elements_a_code_apart": sum(c["elements_a_code_apart"]
                                                       for c in p_main + p_small),
                          "elements": sum(c["elements"] for c in p_main + p_small),
                          "max_err_in_codes": max(c["max_err_in_codes"]
                                                  for c in p_main + p_small)},
            },
        },
        {
            "name": "blocked_segment_sum", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_sum.cu (segment_chain_kernel: the "
                      "chain route, the compiled=False sparse path; segment_sum_kernel: the "
                      "rows route, given the chain rows)",
            "replaces": "src/repro/kernels/segment_sum.py:44",
            "launches": total("blocked_segment_sum"),
            "max_abs_err": max(c["max_abs_err"] for c in chain_main + seg_main + seg_small),
            "ms": mean("ms", chain_main), "plain_ms": mean("plain_ms", chain_main),
            "bound_ms": mean("bound_ms", chain_main), "bound_by": chain_main[0]["bound_by"],
            "library_ms": None,
            "library": "none for the chain route (no one call gathers, chains and sums); "
                       "the rows route's index_add_ in routes.rows",
            "tolerance": "chain route: bit-equal to the rows route over the padded chain (every "
                         "mode at full size) and to the CPU plain version (mode 0), repeatable; "
                         "rows route: bit-equal to the row-ordered CPU plain version (small "
                         "cases, mode 0 at full size), against the card's atomic plain version "
                         "within 2 (bn-1) 2^-24 of each slot's summed magnitudes",
            "per_mode_ms": [c["ms"] for c in chain_main],
            "routes": {
                "chain": {"launches": total("blocked_segment_sum_chain"),
                          "ms": mean("ms", chain_main), "bound_ms": mean("bound_ms", chain_main),
                          "per_mode_ms": [c["ms"] for c in chain_main],
                          "composition_ms": [c["composition_ms"] for c in chain_main]},
                "rows": {"launches": total("blocked_segment_sum_rows"),
                         "ms": mean("ms", seg_main), "plain_ms": mean("plain_ms", seg_main),
                         "bound_ms": mean("bound_ms", seg_main),
                         "bound_by": seg_main[0]["bound_by"],
                         "library_ms": mean("library_ms", seg_main),
                         "library": "index_add_",
                         "max_err_over_max": max(c["max_err_over_max"]
                                                 for c in seg_main + seg_small)},
            },
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:74",
            "launches": total("flash_attention"),
            "max_abs_err": max(c["max_abs_err"] for c in [f_main, f_served] + f_small),
            "ms": f_main["ms"], "plain_ms": f_main["plain_ms"],
            "bound_ms": f_main["bound_ms"], "bound_by": f_main["bound_by"],
            "library_ms": f_main["library_ms"],
            "tolerance": "bf16: one bf16 ulp of the plain version + 2^-16 of sum_j p_j |v_j| "
                         "per element (seeded cases and the served layer-0 q/k/v); f32: "
                         "1e-5 of max|out|; against the served model's attention "
                         "allclose 3e-2",
            "max_err_over_envelope": max(c.get("max_err_over_envelope", 0.0)
                                         for c in [f_main, f_served] + f_small),
            "tflops": f_main["tflops"],
            "routes": {r: total(f"flash_attention_{r}") for r in flash_attention.routes},
        },
        {
            "name": "flash_attention_d256", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu (flash_bf16_kernel<256>: "
                      "64-key K/V tiles, O m64n256k16; head dims 129..256 zero-padded to it)",
            "replaces": "src/repro/kernels/flash_attention.py:74",
            "launches": flash_wide_launches["flash_attention_wgmma"],
            "max_abs_err": max(c["max_abs_err"] for c in [f_d256] + f_small
                               if c["shape"][4] > 128 and c["dtype"] == "bfloat16"
                               and c["shape"][4] <= 256),
            "ms": f_d256["ms"], "plain_ms": f_d256["plain_ms"],
            "bound_ms": f_d256["bound_ms"], "bound_by": f_d256["bound_by"],
            "library_ms": f_d256["library_ms"],
            "library": "scaled_dot_product_attention(is_causal, enable_gqa) without the "
                       "softcap, which it does not take",
            "shape": list(FLASH_D256), "softcap": FLASH_D256_SOFTCAP,
            "ms_no_softcap": f_d256["ms_no_softcap"], "floor_ms": f_d256["floor_ms"],
            "tflops": f_d256["tflops"], "ptxas": f_d256["ptxas"],
            "max_err_over_envelope": f_d256["max_err_over_envelope"],
            "tolerance": "bf16: one bf16 ulp of the plain version + 2^-16 of sum_j p_j |v_j| "
                         "per element; deterministic",
        },
        {
            "name": "flash_attention_slab", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu (flash_slab_kernel: "
                      "D > 256, f32, a grid axis over 256-column output slabs, each forming "
                      "the whole score)",
            "replaces": "src/repro/kernels/flash_attention.py:74",
            "launches": total("flash_attention_slab"),
            "max_abs_err": max(c["max_abs_err"] for c in [f_slab] + f_small
                               if c["shape"][4] > 256),
            "ms": f_slab["ms"], "plain_ms": f_slab["plain_ms"],
            "bound_ms": f_slab["bound_ms"], "bound_by": f_slab["bound_by"],
            "library_ms": f_slab["library_ms"],
            "library": "scaled_dot_product_attention(is_causal, enable_gqa), f32",
            "shape": list(FLASH_SLAB), "dtype": "float32", "slabs": f_slab["slabs"],
            "floor_ms": f_slab["floor_ms"], "tflops": f_slab["tflops"],
            "ptxas": f_slab["ptxas"],
            "tolerance": "f32: 1e-5 of max|out|; bf16 (staged to f32, rounded once): one bf16 "
                         "ulp + 2^-16 of sum_j p_j |v_j|; deterministic",
        },
        {
            "name": "ordered_fold", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ordered_fold.cu (ordered_chain_kernel: the "
                      "chain route, the exact sparse MTTKRP's main path; ordered_fold_kernel: "
                      "the fold route, the compiled=False path's partials)",
            "replaces": "src/repro/core/mttkrp.py:112 (jax.ops.segment_sum, the exact "
                        "sparse CP3 scatter; no Pallas kernel)",
            "launches": total("ordered_fold"),
            "max_abs_err": max([fold_main["max_abs_err"], fold_skew["max_abs_err"]]
                               + [c["max_abs_err"] for c in fold_small]),
            "ms": fold_main["ms"], "plain_ms": fold_main["plain_ms"],
            "bound_ms": fold_main["bound_ms"], "bound_by": fold_main["bound_by"],
            "library_ms": None, "library": "none (no one call gathers, chains and folds in "
                                           "order)",
            "tolerance": "bit-equal to the CPU's stream-ordered fold (small cases; mode 0 of "
                         "the sparse tensor at full size through stream_mttkrp) and "
                         "repeatable; the chain route bit-equal to the stepped route at full "
                         "size; against the card's atomic index_add_ within 2 (L-1) 2^-24 of "
                         "each row's summed magnitudes",
            "routes": {
                "chain": {"launches": total("ordered_fold_chain"), "ms": fold_main["ms"],
                          "bound_ms": fold_main["bound_ms"], "split": fold_main["split"],
                          "head_row_ms": fold_skew["head_row_ms"]},
                "fold": {"launches": total("ordered_fold_fold"),
                         **{k: statistics.fmean(c[k] for c in fold_route)
                            for k in ("ms", "bound_ms", "plain_ms", "library_ms")},
                         "bound_by": "bytes",
                         "library": "index_add_ on the gathered rows (the gather not counted)",
                         "per_mode_ms": [c["ms"] for c in fold_route],
                         "in_call_ms": [sp["parts"]["fold"]["ms"] for sp in leg_split],
                         "long_run_ms": [c["long_run_ms"] for c in fold_route],
                         "step_launch": fold_main["stepped"]["fold_launch"]},
            },
            "stepped_call_ms": fold_main["stepped"]["ms"],
            "stepped_split": fold_main["stepped"]["split"],
            "mesh_launches": {r: mesh_launches[f"ordered_fold_{r}"]
                              for r in ("chain", "chain_psram", "fold")},
        },
        *[{
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": total(name),
            "max_abs_err": max([c[key]["max_abs_err"] for c in psram_main]
                               + [c["max_abs_err"] for c in psram_small]),
            **{k: statistics.fmean(c[key][k] for c in psram_main)
               for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": psram_main[0][key]["bound_by"], "library_ms": None,
            "library": "none (no one call quantizes the chain and folds it)",
            "tolerance": "bit-equal to the plain chain (cp_chain_psram, the CPU's bits) "
                         "folded by the in-order route it replaces (every mode at full "
                         "size), to the CPU plain version (small cases), repeatable",
            **{f"per_mode_{k}": [c[key].get(k) for c in psram_main]
               for k in ("ms", "exact_ms", "plain_ms", "bound_ms", "instruction_bound_ms",
                         "instruction_bound_fdiv_ms", "head_row_ms", "head_row_nnz",
                         "layout", "ptxas")},
            "adc_bits": cfg.adc.bits, "mesh_launches": mesh_launches[name],
        } for name, key, source, replaces in (
            ("ordered_fold_chain_psram", "eager",
             "src/repro_torch/kernels/csrc/ordered_fold.cu (ordered_psram_kernel<RT>: the "
             "chain route's quantized variant at a template rank, the psram-stream eager "
             "path, a long run's producers on a cluster of 8 CTAs; the chain "
             "hopper::psram_chain_pieces in csrc/hopper.cuh)",
             "src/repro/core/mttkrp.py:161 (jax.ops.segment_sum of cp_chain_psram, the "
             "quantized sparse CP3 scatter; no Pallas kernel)"),
            ("blocked_segment_sum_chain_psram", "blocked",
             "src/repro_torch/kernels/csrc/segment_sum.cu (segment_chain_kernel<K, VEC, true>: "
             "the chain route's quantized variant, the psram-stream compiled path; the chain "
             "hopper::psram_chain_pieces)",
             "src/repro/kernels/segment_sum.py:44"))],
        *[split_row(route) for route in ("wgmma", "tile", "decode")],
        {
            "name": "psram_adc_epilogue", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu (psram_adc_epilogue_kernel: "
                      "the ADC + dequant on all-reduced int32 sums, the fused kernels' "
                      "epilogue arithmetic)",
            "replaces": "src/repro/kernels/psram_matmul.py:80 (its epilogue)",
            "launches": total("psram_adc_epilogue"),
            "max_abs_err": max(c["max_abs_err"] for c in split_list),
            # ms, plain_ms and bound_ms: f32 out, CUDA events over eager
            # calls; the device time in a CUDA graph and the bf16 store
            # (the served dtype) beside them under names of their own
            **{k: split_list[-1]["epilogue"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                         "bf16_ms", "bf16_device_ms", "bf16_bound_ms")},
            "library": "none (no one PyTorch call digitizes and scales)",
            "shape": split_list[-1]["shape"][::2],
            "tolerance": "bit-equal to the fused kernel's epilogue (the K split above); bf16 "
                         "the f32 result rounded once",
            "per_shape": [{"shape": c["shape"][::2], **c["epilogue"]} for c in split_list
                          if c["route"] != "tile"],
        },
        rows_row(),
    ]}
    report["kernels"] = kernels
    if opts.out is not None:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(report, indent=1))
    emit(kernels)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
