#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--nnz N] [--out report.json]

What it does, in order — any failure raises and the run exits non-zero:

1. ``device``    — needs a CUDA device (exits 1 without one); builds every
   CUDA kernel of ``src/repro_torch/kernels/csrc`` from source with nvcc
   (all sources at once) and reports the build time.
2. ``data``      — a NELL-2-shaped synthetic sparse tensor (FROSTT's NELL-2
   dimensions 12092 x 9184 x 28818, power-law fibers, ``--nnz`` samples,
   seed 0) and its three mode-rooted CSFs: the host-side preprocessing.
3. ``kernels``   — each kernel's wrapper against its plain PyTorch version
   on the card, at the main path's shapes and at small ragged shapes, with
   CUDA-event timings (median after warm-up) beside the least time the card
   could take for the same bytes and operations.
4. ``main_path`` — launch counters set to 0, then ``cp_als(sparse=coo,
   rank=32, n_iter=3, backend="hopper")`` on the paper's array config and
   ``api.matmul`` at an LM MLP projection (512 x 4096 x 14336), each against
   ``backend="exact"``; then the counters are read.

Output: one JSON object per line; the ``kernels`` line, the card's name and
power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
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

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- kernel B


def matmul_case(torch, m, k, n, seed, adc_bits=16, timed=False):
    """Kernel B against its plain version (bit-equal) at one shape."""
    from repro_torch.core.quantization import QMAX, adc_transfer, quantize_symmetric
    from repro_torch.kernels.psram_matmul import psram_matmul, psram_matmul_torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda")
    qx, sx = quantize_symmetric(x, axis=-1)
    qw, sw = quantize_symmetric(w, axis=0)
    got = psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits)
    torch.cuda.synchronize()
    want = psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits)
    diff = (got - want).abs()
    case = {
        "shape": [m, k, n], "adc_bits": adc_bits,
        "max_abs_err": float(diff.max()),
        "share_differing": float((got != want).float().mean()),
        "bit_equal": bool(torch.equal(got, want)),
    }
    if not case["bit_equal"]:
        raise AssertionError(f"psram_matmul differs from its plain version: {case}")
    if timed:
        def library():
            acc = torch._int_mm(qx, qw)
            full_scale = float(QMAX) * float(QMAX) * k
            return adc_transfer(acc, 2 ** adc_bits, full_scale) * (sx * sw)

        lib_out = library()
        case["library_equal"] = bool(torch.equal(lib_out, want))
        case["ms"] = time_ms(torch, lambda: psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits))
        case["plain_ms"] = time_ms(
            torch, lambda: psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits), iters=3, reps=2)
        case["library_ms"] = time_ms(torch, library)
        bytes_ms = 1e3 * (nbytes(qx, qw, sx, sw) + 4 * m * n) / HBM_BYTES_PER_S
        ops_ms = 1e3 * (2.0 * m * k * n) / INT8_OPS_PER_S
        case["bound_ms"] = max(bytes_ms, ops_ms)
        case["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    return case


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

    got, got_max = stream_mttkrp_fused(*args, plan=plan, return_chunk_max=True)
    torch.cuda.synchronize()
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
        if not (case["bit_equal_to_ordered_plain"]
                and case["chunk_max_bit_equal_to_ordered_plain"]):
            raise AssertionError(
                f"stream_mttkrp_fused is not bit-equal to the ordered plain version: {case}")
    if timed:
        case["ms"] = time_ms(torch, lambda: stream_mttkrp_fused(*args, plan=plan))
        case["plain_ms"] = time_ms(torch, lambda: stream_mttkrp_fused_torch(*args), iters=3, reps=1)
        others = [d for d in range(len(qs)) if d != mode]
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
    spans chunks, 4 modes, rank not a multiple of 32, ADC off."""
    from repro_torch.core.psram import PsramConfig
    from repro_torch.sparse import csf_for_mode, powerlaw_coo

    cases = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    # rows=16, 4 blocks per chunk: the Zipf head row owns far more than the
    # 64 nonzeros of a chunk; 40 rows x ~900 nonzeros leaves tail rows empty
    coo = powerlaw_coo(5, (40, 24, 18), nnz=900, rank=4, alpha=1.6, device="cuda")
    fs = tuple(torch.randn((s, 6), generator=gen, device="cuda") for s in coo.shape)
    cfg = PsramConfig(rows=16)
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
    fs4 = tuple(torch.randn((s, 40), generator=gen, device="cuda") for s in coo4.shape)
    for mode in (0, 3):
        cases.append(stream_case(torch, csf_for_mode(coo4, mode), fs4, PsramConfig(),
                                 16, cpu_bit_check=True))
    return cases


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nnz", type=int, default=16_777_216,
                        help="requested samples of the synthetic tensor")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the whole report to this JSON file")
    opts = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from repro_torch import api
    from repro_torch.backends import resolve_config
    from repro_torch.core.cp_als import cp_als, init_factors
    from repro_torch.kernels import _build
    from repro_torch.kernels.psram_matmul import psram_matmul
    from repro_torch.kernels.stream_mttkrp import stream_mttkrp_fused
    from repro_torch.sparse import csf_for_mode, powerlaw_coo

    report: dict = {}
    card = smi_line()

    # 1. device + build ----------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, path in libs.items() if path.with_suffix(".log").exists()}
    report["device"] = {
        "phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "ptxas": ptxas,
    }
    emit(report["device"])

    # 2. data: host-side preprocessing --------------------------------------
    cfg = resolve_config(None)
    t0 = time.perf_counter()
    coo = powerlaw_coo(0, NELL2_SHAPE, nnz=opts.nnz, rank=8, alpha=1.1, device="cuda")
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csfs = [csf_for_mode(coo, m) for m in range(3)]
    csf_s = time.perf_counter() - t0
    init = init_factors(0, NELL2_SHAPE, RANK, device="cuda")
    report["data"] = {
        "phase": "data", "shape": list(NELL2_SHAPE), "nnz_requested": opts.nnz,
        "nnz": coo.nnz, "synth_s": synth_s, "csf_build_s": csf_s,
        "max_fiber": [int(c.fiber_lengths().max()) for c in csfs],
    }
    emit(report["data"])

    # 3. kernels against their plain versions -------------------------------
    a_main = [stream_case(torch, csfs[m], tuple(init), cfg, cfg.adc.bits, timed=True)
              for m in range(3)]
    a_small = small_stream_cases(torch)
    b_main = matmul_case(torch, *MLP_SHAPE, seed=1, timed=True)
    b_small = [matmul_case(torch, m, k, n, seed=2 + i, adc_bits=bits)
               for i, (m, k, n, bits) in enumerate([
                   (77, 1043, 131, 16),      # nothing a multiple of a tile; K odd
                   (5, 7, 3, 16),
                   (130, 64, 257, 8),
                   (16, 2048, 8, 16),        # accumulator beyond 2^24
               ])]
    report["kernel_cases"] = {
        "phase": "kernel_cases", "stream_main": a_main, "stream_small": a_small,
        "matmul_main": b_main, "matmul_small": b_small,
    }
    emit(report["kernel_cases"])

    # 4. main path ----------------------------------------------------------
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stream_mttkrp_fused.launches = 0
    psram_matmul.launches = 0

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
    torch.cuda.synchronize()

    launches = {"stream_mttkrp_fused": stream_mttkrp_fused.launches,
                "psram_matmul": psram_matmul.launches}

    t0 = time.perf_counter()
    exact = cp_als(None, RANK, n_iter=SWEEPS, sparse=coo, backend="exact",
                   csfs=csfs, init=init)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    y_exact = api.matmul(x, w, backend="exact")
    matmul_rel = float(torch.linalg.norm(y - y_exact) / torch.linalg.norm(y_exact))

    import math

    main_path = {
        "phase": "main_path", "sweeps": SWEEPS, "rank": RANK,
        "fit_hopper": hop.fit, "fit_exact": exact.fit,
        "iters_hopper": hop.iters, "iters_exact": exact.iters,
        "cp_als_hopper_s": hop_s, "cp_als_exact_s": exact_s,
        "host_preprocessing_s": synth_s + csf_s,
        "device_bytes_held": held_before,
        "device_bytes_peak": torch.cuda.max_memory_allocated(),
        "matmul_shape": list(MLP_SHAPE), "matmul_rel_err": matmul_rel,
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
    if launches["psram_matmul"] < 1:
        raise AssertionError(f"api.matmul did not launch the matmul kernel: {main_path}")
    if not all(f.is_cuda and torch.isfinite(f).all() for f in hop.factors) or not y.is_cuda:
        raise AssertionError("results are not finite tensors on the card")
    if tuple(y.shape) != (m, n) or not matmul_rel < 0.05:
        raise AssertionError(f"api.matmul strays from exact: rel {matmul_rel}")

    # per-sweep time, warm: cp_als sorts and merges duplicates on the host
    # before its first sweep, so a sweep is timed on its own — a backend
    # instance that stamps the clock (after a synchronize) whenever mode 0 is
    # asked for marks each sweep's start; the fit of sweep i ends before the
    # stamp of sweep i+1
    from repro_torch import backends

    def sweep_ms(name):
        stamps = []

        class Stamped(type(backends.get(name, cfg))):
            def mttkrp(self, data, factors, mode):
                if mode == 0:
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
                return super().mttkrp(data, factors, mode)

        cp_als(None, RANK, n_iter=SWEEPS + 1, sparse=coo, backend=Stamped(cfg),
               csfs=csfs, init=init, tol=0)
        return [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]

    sweeps = {name: sweep_ms(name) for name in ("hopper", "exact")}

    # what a hopper sweep holds besides its three kernel-A launches, each
    # piece timed alone at the sweep's shapes (plain PyTorch, all of it)
    from repro_torch.kernels.stream_mttkrp import quantize_stream_factors
    from repro_torch.sparse.stream import stream_mttkrp

    fs = tuple(hop.factors)
    gram = fs[0].T @ fs[0]
    sweep_parts_ms = {
        "exact_fit_mttkrp_last_mode": time_ms(
            torch, lambda: stream_mttkrp(csfs[-1], fs), iters=3, reps=1),
        "quantize_factors_3_modes": time_ms(
            torch, lambda: [quantize_stream_factors(fs, mode) for mode in range(3)]),
        "pinv_3_modes": time_ms(
            torch, lambda: [torch.linalg.pinv(gram) for _ in range(3)]),
    }
    report["sweep_time"] = {
        "phase": "sweep_time",
        "per_sweep_ms_hopper": statistics.median(sweeps["hopper"]),
        "per_sweep_ms_exact": statistics.median(sweeps["exact"]),
        "sweeps_ms": sweeps,
        "sweep_parts_ms": sweep_parts_ms,
        "before_first_sweep_s": hop_s - 1e-3 * SWEEPS * statistics.median(sweeps["hopper"]),
    }
    emit(report["sweep_time"])

    # the contract's kernel table -------------------------------------------
    mean = lambda key: statistics.fmean(c[key] for c in a_main)
    kernels = {"kernels": [
        {
            "name": "stream_mttkrp_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/stream_mttkrp.cu",
            "replaces": "src/repro/kernels/stream_mttkrp.py:173",
            "launches": launches["stream_mttkrp_fused"],
            "max_abs_err": max(c["max_abs_err"] for c in a_main + a_small),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": a_main[0]["bound_by"], "library_ms": None,
            "tolerance": "per element: one ADC code (2*chunk full scale/2^16) per "
                         "segment of the row + 1e-6 of the full scales; bit-equal "
                         "to the stream-ordered plain version on the small cases",
            "per_mode_ms": [c["ms"] for c in a_main],
        },
        {
            "name": "psram_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psram_matmul.cu",
            "replaces": "src/repro/kernels/psram_matmul.py:80",
            "launches": launches["psram_matmul"],
            "max_abs_err": max(c["max_abs_err"] for c in [b_main] + b_small),
            "ms": b_main["ms"], "plain_ms": b_main["plain_ms"],
            "bound_ms": b_main["bound_ms"], "bound_by": b_main["bound_by"],
            "library_ms": b_main["library_ms"],
            "tolerance": "bit-equal",
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
