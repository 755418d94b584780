"""Sparse CP decomposition on the streaming pSRAM schedule — a worked map
of §IV's CP1→CP2→CP3 onto a sparse tensor.

The mapping, concretely (repro_torch.sparse.stream):

  * STORED in the array: blocks of CP2 chain rows ``d_p = x_p · (b_j ∘ c_k)``
    — one nonzero per word-line, the R rank values across the word columns
    (``⌈R/32⌉`` rank-tiles when R > 32). CP1 (the Hadamard of the gathered
    factor rows) and CP2 (scaling by the tensor value) happen on the way in.
  * DRIVEN on the word-lines: one *binary gather mask* per output-row
    segment, each on its own WDM channel — up to 52 segments drain per
    optical cycle.
  * CP3 ACCUMULATES twice: optically on the bit-lines (photocurrents of one
    wavelength sum down a column = the segment's partial MTTKRP row), then
    electrically post-ADC across blocks — a fiber spanning a block boundary
    carries its partial sum, which is why results are bit-identical to the
    COO segment-sum path.

On the card the exact sweep's MTTKRPs run the ordered fold's chain route
and the ``"psram-stream"`` sweep its quantized chain route.

Run:  python -m repro_torch.examples.sparse_decompose [--device cpu]
"""
import argparse

import numpy as np

from repro_torch._device import as_device
from repro_torch.core.cp_als import cp_als
from repro_torch.core.perf_model import SparseMTTKRPWorkload, sustained_mttkrp
from repro_torch.core.psram import PsramConfig
from repro_torch.core.schedule import count_cycles, program_energy
from repro_torch.sparse import (
    FiberStats,
    build_stream_program,
    csf_for_mode,
    partition_csf,
    powerlaw_coo,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the tensors live (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)

    shape, rank = (600, 500, 400), 16
    coo = powerlaw_coo(0, shape, nnz=60_000, rank=4, alpha=1.2, device=dev)
    csf = csf_for_mode(coo, 0)
    stats = FiberStats.of(csf.fiber_lengths())
    print(f"tensor {shape}, nnz={coo.nnz} (density {coo.density:.2e})")
    print(f"fiber lengths: mean={stats.mean:.1f} p50={stats.p50:.0f} "
          f"p99={stats.p99:.0f} max={stats.max} — power-law skew")

    # --- decompose: exact streaming backend, then the quantized engine —
    # the same cp_als call, dispatched by registry name
    st = cp_als(None, rank=rank, n_iter=20, sparse=coo, seed=1, tol=0)
    stq = cp_als(None, rank=rank, n_iter=20, sparse=coo,
                 backend="psram-stream", seed=1)
    print(f"CP-ALS fit: float={st.fit:.4f}  pSRAM 8-bit+ADC={stq.fit:.4f} "
          "(backend='psram-stream'; both fits computed exactly — lossy "
          "backend, unbiased metric)")

    # --- price the schedule that ran
    cfg = PsramConfig()
    prog = build_stream_program(csf.fiber_lengths(), rank, cfg)
    c = count_cycles(prog)
    e = program_energy(prog)
    sb = sustained_mttkrp(cfg, SparseMTTKRPWorkload(
        fiber_lengths=csf.fiber_lengths(), rank=rank))
    print(f"one streamed MTTKRP: {c.total_cycles} cycles "
          f"({c.write_cycles} write + {c.compute_cycles} drain), "
          f"{c.duration_s(cfg)*1e6:.1f} us, {e.total_j*1e6:.2f} uJ")
    print(f"model: occupancy={sb.wavelength_occupancy:.3f} "
          f"reconfig={sb.reconfig_efficiency:.3f} "
          f"sustained={sb.sustained_petaops:.4f} PetaOps")

    # --- span a mesh of arrays, nnz-balanced
    meshed = partition_csf(csf, n_arrays=8, rank=rank, config=cfg)
    loads = [p.nnz for p in meshed.partitions]
    naive = int(np.ceil(len(csf.fiber_lengths()) / 8))
    print(f"8 arrays, nnz-balanced: loads={loads} "
          f"imbalance={meshed.imbalance:.3f}, makespan "
          f"{meshed.critical_path_cycles} cycles "
          f"(vs {c.total_cycles} single-array; equal-ROW split would track "
          f"the fattest {naive} fibers instead)")
    return {
        "device": str(stq.factors[0].device), "nnz": coo.nnz, "density": coo.density,
        "fiber_mean": stats.mean, "fiber_max": stats.max,
        "fit_float": st.fit, "fit_psram": stq.fit,
        "total_cycles": c.total_cycles, "write_cycles": c.write_cycles,
        "compute_cycles": c.compute_cycles, "energy_j": e.total_j,
        "sustained_petaops": sb.sustained_petaops, "loads": loads,
        "imbalance": meshed.imbalance, "makespan_cycles": meshed.critical_path_cycles,
    }


if __name__ == "__main__":
    main()
