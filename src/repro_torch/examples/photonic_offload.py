"""Photonic offload: run an LM with every projection through the pSRAM
engine simulation, and the array's int8 matmul kernel on a single matmul.

Shows (1) end-to-end numerical fidelity of 8-bit photonic projections (on
the card every projection runs kernel 2, the hand-written Hopper matmul),
(2) kernel 2 (``lowering="cuda"`` on the card, its plain version
``"torch"`` on the CPU) agreeing bit-exactly with the array transfer
function (``"ref"``), (3) the tile-schedule executor running a projection
bit-identically to the per-cycle array oracle, with its counted cycle /
energy bill, (4) the schedule-derived cost of offloading one decode step.

Run:  python -m repro_torch.examples.photonic_offload [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch._device import as_device
from repro_torch.core.perf_model import measured_utilization, peak_petaops
from repro_torch.core.psram import PsramConfig
from repro_torch.core.schedule import (
    build_matmul_program,
    count_cycles,
    execute,
    execute_reference,
    program_energy,
)
from repro_torch.kernels.ops import psram_matmul_op
from repro_torch.models.registry import get_config, get_module
from repro_torch.serve.engine import offload_report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the tensors live (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)

    cfg = get_config("granite_8b").reduced()
    mod = get_module(cfg)
    params = mod.init(0, cfg, device=dev)
    gen = torch.Generator()
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen).to(dev)

    sweep = []
    with torch.no_grad():
        exact = mod.forward(params, toks, cfg)
        for bits in (8, 12, 16):
            c = dataclasses.replace(cfg, psram_projections=True, adc_bits=bits)
            q = mod.forward(params, toks, c)
            rel = float(torch.linalg.norm(q - exact) / torch.linalg.norm(exact))
            agree = float(torch.mean((q.argmax(-1) == exact.argmax(-1)).float()))
            print(f"ADC {bits:2d}-bit: logits rel_err={rel:.4f} "
                  f"argmax agreement={agree:.3f}")
            sweep.append({"adc_bits": bits, "rel_err": rel, "argmax_agreement": agree})

    # the array's int8 matmul kernel on one projection
    gen.manual_seed(2)
    x = torch.randn((128, 256), generator=gen).to(dev)
    gen.manual_seed(3)
    w = torch.randn((256, 128), generator=gen).to(dev)
    lowering = "cuda" if dev.type == "cuda" else "torch"
    y_kernel = psram_matmul_op(x, w, lowering=lowering)
    y_ref = psram_matmul_op(x, w, lowering="ref")
    diff = float(torch.max(torch.abs(y_kernel - y_ref)))
    print(f"\nkernel 2 ({lowering}) vs array oracle: "
          f"max|diff|={diff:.2e} (bit-exact)")

    # the tile-schedule executor on one projection: bit-identical to the
    # per-cycle oracle, with the schedule's counted cycle and energy bill
    arr = PsramConfig()
    prog = build_matmul_program(128, 256, 128, arr)
    y_vec = execute(prog, x, w)
    y_loop = execute_reference(prog, x, w)
    counts = count_cycles(prog)
    e = program_energy(prog)
    mu = measured_utilization(prog)
    bit_identical = bool(torch.equal(y_vec, y_loop))
    print(f"\nschedule executor vs per-cycle oracle: bit_identical="
          f"{bit_identical}; {counts.compute_cycles} compute"
          f" + {counts.write_cycles} write cycles ({counts.duration_s(arr)*1e9:.0f} ns"
          f" @ {arr.frequency_ghz:.0f} GHz), {e.total_j*1e9:.1f} nJ, "
          f"measured utilization {mu.utilization:.3f}")

    # what would the array sustain on these projections?
    full = get_config("granite_8b")
    proj_macs = 2 * full.param_count()  # one token through all projections
    t_ns = proj_macs * 2 / (peak_petaops(arr) * 1e15) * 1e9
    print(f"\nperf model: one granite-8b decode step's projections "
          f"({proj_macs/1e9:.1f} GMAC) on one pSRAM array: {t_ns:.0f} ns "
          f"(@ {peak_petaops(arr):.1f} PetaOps)")

    # schedule-derived bill for one decode step of the reduced model: the
    # serve engine prices one MatmulWorkload per unique projection shape
    # through api.estimate on the selected backend
    rep = offload_report(cfg, backend="psram-scheduled", device=dev)
    print(f"\nserve offload report ({cfg.name}, batch 1, "
          f"backend={rep['backend']}): "
          f"{rep['time_s']*1e6:.1f} us/step, "
          f"{rep['energy'].total_j*1e6:.2f} uJ, "
          f"utilization {rep['utilization'].utilization:.4f} "
          f"(write-cycle bound at batch 1), "
          f"projection rel_err {rep['projection_rel_err']:.4f}")
    return {
        "device": str(y_kernel.device), "adc_sweep": sweep, "kernel_lowering": lowering,
        "kernel_max_abs_diff": diff, "schedule_bit_identical": bit_identical,
        "compute_cycles": counts.compute_cycles, "write_cycles": counts.write_cycles,
        "energy_j": e.total_j, "measured_utilization": mu.utilization,
        "decode_step_ns": t_ns, "offload_time_s": rep["time_s"],
        "offload_energy_j": rep["energy"].total_j,
        "offload_utilization": rep["utilization"].utilization,
        "projection_rel_err": rep["projection_rel_err"],
    }


if __name__ == "__main__":
    main()
