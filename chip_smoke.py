#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--nnz N] [--out report.json] [--tuning]

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
   the tile route at a ragged 1000-column head; the decode route at
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
   the call beside its chain-route launch (``exact_sparse_split``).
4. ``main_path`` — three paths, each run with every launch counter set to 0
   just before it and read just after:
   a. ``cp_als(sparse=coo, rank=32, n_iter=3, backend="hopper")`` on the
      paper's array config and ``api.matmul`` at an LM MLP projection
      (512 x 4096 x 14336, kernel 2's wgmma route) and a 1000-class head
      (512 x 4096 x 1000, the tile route), each against ``backend="exact"``;
   b. the dense entry point: ``api.mttkrp(x, factors, mode,
      backend="hopper")`` and ``backends.get("hopper", compiled=False)``
      for every mode of the dense tensor, against ``backend="exact"``;
   c. ``cp_als`` on the sparse tensor with ``backends.get("hopper",
      compiled=False)`` (the blocked segment-sum stream, its partials folded
      in order), against the exact run of (a); then the blocked path on
      every mode twice: the same bits.
   d. ``main_path_flash``: ``kernels.ops.flash_attention_op`` at its
      docstring's shape, a 32k-token causal prefill at granite-8b's
      attention widths (B=1, H=32, Hkv=8, D=128, bf16), and on layer 0's
      post-RoPE q/k/v of the served model below, against the model's own
      attention and (one-ulp envelope) against the kernel's plain version;
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
5. ``sweep_time`` — one warm sweep of each CP-ALS engine, and the parts of a
   ``hopper`` sweep timed alone.

TF32 is switched off for matmuls and cuDNN before anything runs: the plain
versions of the dense MTTKRP and flash kernels are f32 matrix products.

Output: one JSON object per line (each phase's with its wall seconds,
``phase_wall_s``); the ``kernels`` line, the card's name and
power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
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

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
# cycles between two dependent f32 adds on an SM, the chain floor's unit (an
# assumption: Hopper's FADD latency is not published)
FADD_CYCLES = 4
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


_LAST_EMIT = [time.perf_counter()]


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
        perm, coords, runs, longest, _ = _sorted_stream(coo.indices, m, rows)
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
    route and a second launch (bit-equal). With ``timed``: the route's time
    (the wgmma route in turns with the tile route: wgmma, tile, tile,
    wgmma), the plain version's, the bound and the library's
    (``torch._int_mm`` + the ADC epilogue, for more than 16 rows)."""
    from repro_torch.core.quantization import QMAX, adc_transfer
    from repro_torch.kernels.psram_matmul import _launch, psram_matmul, psram_matmul_torch

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
    if not (case["bit_equal"] and case["deterministic"] and case.get("bit_equal_to_tile", True)):
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
        case["plain_ms"] = time_ms(
            torch, lambda: psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits), iters=3, reps=2)
        if m > 16:                        # torch._int_mm takes more than 16 rows only
            case["library_equal"] = bool(torch.equal(library(), got))
            case["library_ms"] = time_ms(torch, library)
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
    coords, seg_ptr, seg_rows, run, _ = _chain_stream(csf)
    step = _DEFAULT_EXEC_NNZ
    step_ptr, step_rows, chunk_seg = step_cuts(torch, csf, step)
    los = list(range(0, csf.nnz, step))
    zeros = lambda: torch.zeros((rows, rank), device="cuda")

    def chain(out):                      # as stream_mttkrp launches it
        return of.ordered_chain_fold(out, coords, vals, fs, mode, seg_ptr, seg_rows,
                                     longest_run=run)

    def stepped(out):                    # as the parent's stream_mttkrp ran it
        for c, lo in enumerate(los):
            d = cp_chain_exact(idx[lo:lo + step], vals[lo:lo + step], fs, mode)
            of._fold_runs(out, d, step_ptr, step_rows, chunk_seg[c], chunk_seg[c + 1], lo)
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
            and launched == {"fold": 0, "chain": 1}
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
    parts = [(d[lo:lo + step], ids[lo:lo + step], (chunk_seg[c], chunk_seg[c + 1], lo))
             for c, lo in enumerate(los)]

    def fold_steps(out):
        for dc, _, (first, last, lo) in parts:
            of._fold_runs(out, dc, step_ptr, step_rows, first, last, lo)
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
    coords, seg_ptr, seg_rows, _, _ = _chain_stream(csf)
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
            and launched == {"fold": 0, "chain": 1}):
        raise AssertionError(f"stream_mttkrp on the card is not one in-order chain-route "
                             f"launch: {case}")
    return case


def small_fold_cases(torch):
    """The fold kernel on its own against the CPU's index_add_ (bit-equal):
    16-byte and 4-byte copies, a misaligned d, one-row stages (R over
    2048), a run longer than the ring, empty rows, a nonzero start."""
    from repro_torch.kernels.ordered_fold import ordered_fold, ordered_fold_torch

    gen = torch.Generator(device="cuda").manual_seed(14)
    cases = []
    for n, rows, r, offset in [(5000, 23, 32, 0), (5000, 23, 6, 0), (5000, 23, 40, 1),
                               (300, 23, 3000, 0), (70000, 4, 32, 0)]:
        ids = torch.randint(0, rows, (n,), generator=gen, device="cuda").sort().values
        d = torch.randn((n * r + offset,), generator=gen, device="cuda")[offset:].view(n, r)
        start = torch.randn((rows, r), generator=gen, device="cuda")
        got = ordered_fold(start.clone(), d, ids)
        want = ordered_fold_torch(start.cpu(), d.cpu(), ids.cpu())
        case = {"n": n, "rows": rows, "rank": r, "offset": offset,
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
    ``timed`` its times, bound and (bf16) the floor of its two-term design."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_torch

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
        if softcap > 0:
            case["library_ms"] = None
        else:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            case["library_ms"] = time_ms(torch, lambda: sdpa(
                q, k, v, is_causal=causal, scale=sc, enable_gqa=True))
        # unmasked (query, key) pairs: row i sees keys 0..min(i, skv - 1)
        pairs = b * h * (sum(min(i + 1, skv) for i in range(s)) if causal else s * skv)
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        ops_ms = 1e3 * 4.0 * d * pairs / peak
        bytes_ms = 1e3 * (nbytes(q, k, v) + nbytes(got)) / HBM_BYTES_PER_S
        case["bound_ms"] = max(ops_ms, bytes_ms)
        case["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        if dtype == torch.bfloat16:
            # P V twice (hi + lo): 6 D operations a pair on the tensor cores
            case["floor_ms"] = max(1e3 * 6.0 * d * pairs / peak, bytes_ms)
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
    with Sq != Skv both ways (top-left aligned); and a shape the reference
    refuses, which must raise."""
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


# ------------------------------------------------------------ serving


def serve_run(torch, cfg, params, prompts, eng_cls, zero_counts, read_counts):
    """One ``ServeEngine.generate`` (after a short warm-up) with the launch
    counters set to 0 just before it and read just after, then its prefill
    and a decode step timed alone, and the first decode step's logits held
    against ``forward`` on prompt + token. Returns (report, launches,
    prefill logits, engine, generated tokens)."""
    from repro_torch.models import transformer

    b, p = prompts.shape
    eng = eng_cls(cfg, params, max_len=p + SERVE_NEW, device="cuda")
    eng.generate(prompts, p, 2)                                   # warm-up
    zero_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, p, SERVE_NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    out = {"generate_s": total_s, "tokens_per_s": b * SERVE_NEW / total_s,
           "tokens_shape": list(toks.shape),
           "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab_size)).all())}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = eng.prefill_fn(params, prompts)
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
        out["decode_profile"] = profile_decode(torch, eng, params, cache, tok, p + 9, 8)
        out["prefill_profile"] = profile_prefill(torch, eng, params, prompts)
        full = transformer.forward(params, torch.cat([prompts, tok[:, None]], dim=1), cfg)[:, -1]
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


def profile_prefill(torch, eng, params, prompts, attempts: int = 3) -> dict:
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
            eng.prefill_fn(params, prompts)
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

    def both(qx, qw, sx, sw, adc_bits=16):
        out = launch(qx, qw, sx, sw, adc_bits=adc_bits)
        if qx.shape[0] <= M_DECODE:
            counts["compared"] += 1
            tile = _launch(qx, qw, sx, sw, adc_bits=adc_bits, route="tile")
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


def served_matmul_cases(torch, eng, params, prompts):
    """Kernel 2 held BIT-EQUAL to its plain version on the served model's own
    operands: the codes and scales that layer 0's seven projections (wq, wk,
    wv, wo, wi, wg, wo) hand the kernel in one prefill (M = B*S rows, the
    wgmma route, also held against the tile route) and in one decode step
    (M = B rows, the decode route). The model's module-level
    ``psram_matmul`` is wrapped for these two calls only; its launches here
    are not counted on the main path."""
    import repro_torch.core.photonic_layer as photonic
    from repro_torch.kernels.psram_matmul import _launch, psram_matmul_torch

    launch = photonic.psram_matmul
    seen = []

    def record(qx, qw, sx, sw, adc_bits=16):
        out = launch(qx, qw, sx, sw, adc_bits=adc_bits)
        if len(seen) < 7:
            seen.append((qx, qw, sx, sw, adc_bits, out))
        return out

    cases = []
    routes = launch.routes
    photonic.psram_matmul = record
    try:
        with torch.inference_mode():
            r0 = dict(routes)
            logits, cache = eng.prefill_fn(params, prompts)
            torch.cuda.synchronize()
            r1 = dict(routes)
            calls, seen = seen, []
            eng.step_fn(params, cache, logits.argmax(-1).to(torch.int32), prompts.shape[1])
            torch.cuda.synchronize()
            r2 = dict(routes)
            calls += seen
    finally:
        photonic.psram_matmul = launch
    del logits, cache
    if len(calls) != 14:
        raise AssertionError(f"layer 0 made {len(calls)} kernel-2 calls in a prefill and a "
                             f"decode step, not 2 x 7")
    # every projection of the prefill took the wgmma route, every one of the
    # decode step the decode route
    took = [{r: r1[r] - r0[r] for r in routes}, {r: r2[r] - r1[r] for r in routes}]
    n_proj = 7 * eng.cfg.num_layers
    if took != [{"wgmma": n_proj, "tile": 0, "decode": 0},
                {"wgmma": 0, "tile": 0, "decode": n_proj}]:
        raise AssertionError(f"the served projections did not take the expected routes "
                             f"(prefill, decode step): {took}")
    for i, (qx, qw, sx, sw, adc_bits, got) in enumerate(calls):
        want = psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits)
        case = {"shape": [qx.shape[0], qx.shape[1], qw.shape[1]], "adc_bits": adc_bits,
                "route": "wgmma" if i < 7 else "decode",
                "max_abs_err": float((got - want).abs().max()),
                "bit_equal": bool(torch.equal(got, want))}
        if i < 7:
            case["bit_equal_to_tile"] = bool(torch.equal(
                _launch(qx, qw, sx, sw, adc_bits=adc_bits, route="tile"), got))
        cases.append(case)
        if not (case["bit_equal"] and case.get("bit_equal_to_tile", True)):
            raise AssertionError(f"psram_matmul differs from its plain version on the "
                                 f"served model's operands: {case}")
        del want
    return cases


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nnz", type=int, default=16_777_216,
                        help="requested samples of the synthetic tensor")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the whole report to this JSON file")
    parser.add_argument("--tuning", action="store_true",
                        help="also time kernel 2's decode route at every cluster size "
                             "and both routes over every M of the crossover sweep")
    opts = parser.parse_args(argv)
    _LAST_EMIT[0] = time.perf_counter()

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
    from repro_torch.core.mttkrp import cp_chain_exact
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mttkrp import (
        mttkrp_fused, mttkrp_psram_fused, quantize_mttkrp_operands)
    from repro_torch.kernels.ordered_fold import ordered_fold
    from repro_torch.kernels.psram_matmul import psram_matmul
    from repro_torch.kernels.segment_sum import blocked_segment_sum
    from repro_torch.kernels.stream_mttkrp import stream_mttkrp_fused
    from repro_torch.sparse import csf_for_mode, powerlaw_coo
    from repro_torch.sparse.stream import _segment_blocks

    kernel_fns = {"stream_mttkrp_fused": stream_mttkrp_fused, "psram_matmul": psram_matmul,
                  "mttkrp_fused": mttkrp_fused, "mttkrp_psram_fused": mttkrp_psram_fused,
                  "blocked_segment_sum": blocked_segment_sum,
                  "flash_attention": flash_attention, "ordered_fold": ordered_fold}

    def zero_counts():
        torch.cuda.synchronize()
        for fn in kernel_fns.values():
            fn.launches = 0
        for fn in (psram_matmul, stream_mttkrp_fused, ordered_fold):
            fn.routes = {route: 0 for route in fn.routes}

    def read_counts():
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in kernel_fns.items()}
        for name, fn in (("psram_matmul", psram_matmul), ("stream_mttkrp_fused",
                                                          stream_mttkrp_fused),
                         ("ordered_fold", ordered_fold)):
            counts.update({f"{name}_{route}": n for route, n in fn.routes.items()})
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
    report["device"] = {
        "phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "ptxas": ptxas, "sass": sass,
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
    d_main, p_main = [], []
    for mode in range(3):
        others = [d for d in range(3) if d != mode]
        x0 = xd.permute([mode] + others).reshape(DENSE_SHAPE[mode], -1).contiguous()
        b, c = fd[others[0]], fd[others[1]]
        d_main.append(dense_case(torch, x0, b, c, timed=True))
        q = quantize_mttkrp_operands(x0, b, c)
        del x0
        p_main.append(psram_case(torch, q, timed=True))
        del q
    d_small, p_small = small_dense_cases(torch)
    seg_main, seg_host_s = [], []
    for mode in range(3):
        t0 = time.perf_counter()
        ip, vp, local, n_seg = _segment_blocks(csfs[mode], cfg.rows)[:4]
        seg_host_s.append(time.perf_counter() - t0)
        chain = cp_chain_exact(ip, vp, tuple(init), mode)         # (B, rows, R)
        # mode 0 (the longest fibers) is also held bit for bit at full size
        seg_main.append(segment_case(torch, chain, local, n_seg, timed=True,
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
    f_main = flash_case(torch, *FLASH_MAIN, torch.bfloat16, causal=True, seed=21, timed=True)
    f_small = small_flash_cases(torch)
    report["kernel_cases"] = {
        "phase": "kernel_cases", "stream_main": a_main, "stream_small": a_small,
        "matmul_main": b_main, "matmul_prefill": b_prefill, "matmul_ragged": b_ragged,
        "matmul_epilogue": b_epilogue, "matmul_decode": b_decode, "matmul_small": b_small,
        "matmul_decode_small": b_decode_small, "matmul_crossover": b_crossover,
        "fold_main": fold_main, "fold_skew": fold_skew, "fold_small": fold_small,
        "exact_sparse_split": fold_split,
        "dense_main": d_main, "dense_small": d_small,
        "dense_psram_main": p_main, "dense_psram_small": p_small,
        "segment_main": seg_main, "segment_small": seg_small,
        "segment_host_s": seg_host_s,
        "flash_main": f_main, "flash_small": f_small,
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
    dense_path = {
        "phase": "main_path_dense", "shape": list(DENSE_SHAPE), "rank": RANK,
        "rel_err_hopper": dense_rel, "rel_err_hopper_legacy": legacy_rel,
        "launches": dense_launches, "seconds": dense_s, "device_bytes_peak": dense_peak,
        "call_ms": api_ms,
    }
    report["main_path_dense"] = dense_path
    emit(dense_path)
    del xd, want, got, got_legacy
    if not max(dense_rel) < 0.05 or not max(legacy_rel) < 1e-5:
        raise AssertionError(f"dense MTTKRP strays from exact: {dense_path}")
    if dense_launches["mttkrp_psram_fused"] < 3 or dense_launches["mttkrp_fused"] < 3:
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
    # the blocked path folds its partials in order: the same bits twice
    from repro_torch.sparse.stream import stream_mttkrp_blocked

    leg_repeatable = all(
        torch.equal(stream_mttkrp_blocked(c, leg.factors, cfg),
                    stream_mttkrp_blocked(c, leg.factors, cfg)) for c in csfs)
    blocks = [_segment_blocks(c, cfg.rows) for c in csfs]
    legacy_path = {
        "phase": "main_path_legacy", "sweeps": SWEEPS, "rank": RANK,
        "fit_hopper_legacy": leg.fit, "fit_exact": exact.fit, "iters": leg.iters,
        "cp_als_s": leg_s, "launches": leg_launches, "blocked_repeatable": leg_repeatable,
        "n_seg": [bl[3] for bl in blocks],
        "partials_bytes": [bl[2].shape[0] * bl[3] * RANK * 4 for bl in blocks],
        "chain_bytes": [bl[2].numel() * RANK * 4 for bl in blocks],
        "device_bytes_peak": torch.cuda.max_memory_allocated(),
    }
    report["main_path_legacy"] = legacy_path
    emit(legacy_path)
    if not math.isfinite(leg.fit) or abs(leg.fit - exact.fit) >= 1e-4:
        raise AssertionError(f"legacy CP-ALS strays from exact: {legacy_path}")
    if leg_launches["blocked_segment_sum"] < 3 * SWEEPS or leg.iters != SWEEPS:
        raise AssertionError(f"the legacy path did not launch the segment-sum kernel: {legacy_path}")
    if leg_launches["ordered_fold_fold"] < 3 * SWEEPS or not leg_repeatable:
        raise AssertionError(f"the legacy path's partials were not folded in order, or not "
                             f"repeatably: {legacy_path}")
    if not all(f.is_cuda and torch.isfinite(f).all() for f in leg.factors):
        raise AssertionError("legacy CP-ALS factors are not finite tensors on the card")


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

    # 4e. serving granite-8b, exact and pSRAM projections -----------------
    scfg = get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sparams = transformer.init(7, scfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(2, scfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device="cuda",
                            dtype=torch.int32,
                            generator=torch.Generator(device="cuda").manual_seed(8))
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
        flash_launches["flash_attention"] += read_counts()["flash_attention"]
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
    del sparams
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pcfg = dataclasses.replace(scfg, psram_projections=True, psram_stored_int8=True)
    pparams = transformer.init(9, pcfg, device="cuda")
    int8_bytes = sum(w["q"].numel() for g in pparams["blocks"] for lay in g.values()
                     for blk in (lay["mixer"], lay["mlp"]) for w in blk.values())
    psram_run, psram_launches, psram_logits, peng, ptoks = serve_run(
        torch, pcfg, pparams, prompts, ServeEngine, zero_counts, read_counts)
    # the first TOKENS_CHECKED greedy tokens again, every decode projection
    # also computed on the tile route and held bit-equal: what the tile
    # route would have served, and the same tokens
    psram_run["decode_route_vs_tile_route"] = routes_agree(torch, peng, prompts, ptoks)
    del peng, ptoks
    served_matmul = served_matmul_cases(
        torch, ServeEngine(pcfg, pparams, max_len=SERVE_PROMPT + SERVE_NEW, device="cuda"),
        pparams, prompts)
    # the same prompts through an exact model whose weights are the array's
    # words dequantized (q * scale, rounded to bf16)
    dparams = {**pparams, "blocks": [
        {key: {**lay, **{blk: {name: (w["q"].float() * w["scale"]).to(torch.bfloat16)
                               for name, w in lay[blk].items()}
                         for blk in ("mixer", "mlp")}}
         for key, lay in g.items()}
        for g in pparams["blocks"]]}
    with torch.inference_mode():
        deq_logits, _ = transformer.prefill(dparams, prompts, scfg, SERVE_PROMPT)
    psram_vs_deq = float(torch.linalg.norm(psram_logits - deq_logits)
                         / torch.linalg.norm(deq_logits))
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
    del pparams, dparams, psram_logits, deq_logits, exact_logits
    torch.cuda.empty_cache()
    for name, run in (("exact", exact_run), ("psram", psram_run)):
        if not (run["finite"] and run["tokens_in_vocab"]
                and run["tokens_shape"] == [SERVE_BATCH, SERVE_NEW]):
            raise AssertionError(f"serving ({name}) gave no finite in-vocab tokens: {serve_path}")
        if not run["decode_vs_forward_rel_l2"] <= 0.05:
            raise AssertionError(f"decode strays from forward ({name}): {serve_path}")
    if not (math.isfinite(psram_vs_deq) and psram_vs_deq < 0.5):
        raise AssertionError(f"pSRAM prefill logits are garbage: {serve_path}")
    if psram_launches["psram_matmul"] < 7 * scfg.num_layers * (1 + SERVE_NEW):
        raise AssertionError(f"the pSRAM serve path did not launch kernel 2 on every "
                             f"projection: {serve_path}")
    if psram_launches["psram_matmul_decode"] < 7 * scfg.num_layers * (SERVE_NEW - 1):
        raise AssertionError(f"the pSRAM decode steps did not take kernel 2's decode "
                             f"route: {serve_path}")
    if psram_launches["psram_matmul_wgmma"] < 7 * scfg.num_layers \
            or psram_launches["psram_matmul_tile"] != 0:
        raise AssertionError(f"the pSRAM prefill did not take kernel 2's wgmma route on "
                             f"every projection: {serve_path}")
    prefill_k2 = psram_run["prefill_profile"]["kernel2_launches"]
    if prefill_k2 != 7 * scfg.num_layers:
        raise AssertionError(f"the profiled pSRAM prefill launched kernel 2 {prefill_k2} "
                             f"times, not {7 * scfg.num_layers}: {serve_path}")
    if psram_run["decode_profile"]["kernel_launches_per_step"] > PSRAM_DECODE_LAUNCH_CEILING:
        raise AssertionError(f"a pSRAM decode step launches more than "
                             f"{PSRAM_DECODE_LAUNCH_CEILING} kernels: {serve_path}")

    # per-sweep time, warm: cp_als sorts and merges duplicates on the host
    # before its first sweep, so a sweep is timed on its own — a backend
    # instance that stamps the clock (after a synchronize) whenever mode 0 is
    # asked for marks each sweep's start; the fit of sweep i ends before the
    # stamp of sweep i+1
    def sweep_ms(name, **kwargs):
        stamps = []

        class Stamped(type(backends.get(name, cfg))):
            def mttkrp(self, data, factors, mode):
                if mode == 0:
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
                return super().mttkrp(data, factors, mode)

        cp_als(None, RANK, n_iter=SWEEPS + 1, sparse=coo, backend=Stamped(cfg, **kwargs),
               csfs=csfs, init=init, tol=0)
        return [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]

    sweeps = {name: sweep_ms(name) for name in ("hopper", "exact")}
    sweeps["hopper_legacy"] = sweep_ms("hopper", compiled=False)

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
        # one mode of a legacy sweep: exact chain + kernel 5 + scatter
        "legacy_mttkrp_per_mode": [time_ms(
            torch, lambda m=m: stream_mttkrp_blocked(csfs[m], fs, cfg), iters=3, reps=1)
            for m in range(3)],
    }
    report["sweep_time"] = {
        "phase": "sweep_time",
        "per_sweep_ms_hopper": statistics.median(sweeps["hopper"]),
        "per_sweep_ms_exact": statistics.median(sweeps["exact"]),
        "per_sweep_ms_hopper_legacy": statistics.median(sweeps["hopper_legacy"]),
        "sweeps_ms": sweeps,
        "sweep_parts_ms": sweep_parts_ms,
        "before_first_sweep_s": hop_s - 1e-3 * SWEEPS * statistics.median(sweeps["hopper"]),
    }
    emit(report["sweep_time"])

    # the contract's kernel table -------------------------------------------
    def mean(key, cases=a_main):
        return statistics.fmean(c[key] for c in cases)

    f_served = flash_path["served_layer0"]["vs_plain"]
    main_paths = (launches, dense_launches, leg_launches, flash_launches, exact_launches,
                  psram_launches)

    def total(name):
        return sum(counts[name] for counts in main_paths)

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
        },
        {
            "name": "psram_matmul_wgmma", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu (psram_matmul_wgmma_kernel: "
                      "the wgmma route, M > M_DECODE, operands TMA can take)",
            "replaces": "src/repro/kernels/psram_matmul.py:80",
            "launches": total("psram_matmul_wgmma"),
            "max_abs_err": max(c["max_abs_err"] for c in [b_main] + b_prefill + wgmma_small
                               + [c for c in served_matmul if c["route"] == "wgmma"]),
            "ms": b_main["ms"], "plain_ms": b_main["plain_ms"],
            "bound_ms": b_main["bound_ms"], "bound_by": b_main["bound_by"],
            "library_ms": b_main["library_ms"],
            "library": "torch._int_mm + ADC",
            "tolerance": "bit-equal to the plain version and to the tile route (seeded "
                         "shapes, the prefill's four shapes at M = 8192, and the served "
                         "model's layer-0 operands in a prefill)",
            "shape": b_main["shape"], "tile_ms": b_main["tile_ms"],
            "per_shape": [{k: c[k] for k in ("shape", "ms", "tile_ms", "bound_ms", "plain_ms",
                                             "library_ms", "tops")}
                          for c in [b_main] + b_prefill],
            "epilogue": b_epilogue,
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
            "shape": b_ragged["shape"], "ms_at_mlp_shape": b_main["tile_ms"],
        },
        {
            "name": "psram_matmul_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu (psram_matmul_decode_kernel: "
                      "the decode route, M <= M_DECODE)",
            "replaces": "src/repro/kernels/psram_matmul.py:80",
            "launches": total("psram_matmul_decode"),
            "max_abs_err": max(c["max_abs_err"] for c in b_decode + b_decode_small
                               + [c for c in served_matmul if c["route"] == "decode"]),
            "ms": b_decode[2]["ms"], "plain_ms": b_decode[2]["plain_ms"],
            "bound_ms": b_decode[2]["bound_ms"], "bound_by": b_decode[2]["bound_by"],
            "library_ms": b_decode[2]["library_ms"], "library": b_decode[2]["library"],
            "tolerance": "bit-equal to the plain version and to the tile route (seeded "
                         "shapes, every cluster size, and the served model's layer-0 "
                         "operands in a decode step)",
            "shape": b_decode[2]["shape"], "tile_ms": b_decode[2]["tile_ms"],
            "per_shape": [{k: c[k] for k in ("shape", "cluster", "ms", "tile_ms", "bound_ms",
                                             "library_ms")} for c in b_decode],
        },
        row("mttkrp_fused", "src/repro_torch/kernels/csrc/mttkrp.cu",
            "src/repro/kernels/mttkrp.py:54", d_main, d_small,
            "allclose rtol 2e-4, atol 2e-4 * max|plain|",
            max_rel_err=max(c["max_rel_err"] for c in d_main + d_small),
            max_err_over_max=max(c["max_err_over_max"] for c in d_main + d_small)),
        row("mttkrp_psram_fused", "src/repro_torch/kernels/csrc/mttkrp.cu",
            "src/repro/kernels/mttkrp.py:121", p_main, p_small,
            "per element: 2 ADC codes of its 128-row tile's full scale + rtol 2e-4",
            elements_a_code_apart=sum(c["elements_a_code_apart"] for c in p_main + p_small),
            elements=sum(c["elements"] for c in p_main + p_small),
            max_err_in_codes=max(c["max_err_in_codes"] for c in p_main + p_small),
            main_max_err_in_codes=[c["max_err_in_codes"] for c in p_main]),
        row("blocked_segment_sum", "src/repro_torch/kernels/csrc/segment_sum.cu",
            "src/repro/kernels/segment_sum.py:44", seg_main, seg_small,
            "bit-equal to the row-ordered CPU plain version (small cases, mode 0 "
            "at full size); against the card's atomic plain version within "
            "2 (bn-1) 2^-24 of each slot's summed magnitudes",
            max_err_over_max=max(c["max_err_over_max"] for c in seg_main + seg_small)),
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
                         **fold_main["stepped"]["fold_launch"]},
            },
            "stepped_call_ms": fold_main["stepped"]["ms"],
            "stepped_split": fold_main["stepped"]["split"],
        },
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
