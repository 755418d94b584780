"""Quickstart: tensor decomposition on the photonic engine, end to end.

1. Build a synthetic low-rank 3-mode tensor.
2. Run CP-ALS with the exact float MTTKRP.
3. Run CP-ALS again with the MTTKRP dispatched *by backend name* through
   the unified registry (``backend="psram-oracle"`` — 8-bit intensity
   inputs, binary bitcells, ADC): the paper's engine as one line.
4. Compare fits and ask ``repro_torch.api.estimate`` what the predictive
   performance model says the array would sustain on this workload (and
   the paper's 17 PetaOps point).

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch import api
from repro_torch._device import as_device
from repro_torch.core.cp_als import cp_als
from repro_torch.core.mttkrp import dense_to_coo
from repro_torch.core.perf_model import MTTKRPWorkload, peak_petaops
from repro_torch.data.tensors import lowrank_dense


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the tensors live (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)

    shape, rank = (48, 40, 32), 4
    x, _ = lowrank_dense(0, shape, rank=rank, device=dev)
    print(f"tensor {shape}, true rank {rank}")

    st_f = cp_als(x, rank=rank, n_iter=40, seed=1)
    print(f"float CP-ALS      fit={st_f.fit:.4f} ({st_f.iters} iters)")

    idx, vals = dense_to_coo(x)
    st_q = cp_als(None, rank=rank, n_iter=40, coo=(idx, vals, shape),
                  backend="psram-oracle", seed=1)
    print(f"pSRAM CP-ALS      fit={st_q.fit:.4f} (backend='psram-oracle': "
          "8-bit + ADC engine, fit computed exactly)")
    print(f"quantization gap  {st_f.fit - st_q.fit:+.4f}")

    # one facade, one workload union: estimate without running
    wl = MTTKRPWorkload(i=shape[0], j=shape[1], k=shape[2], rank=rank)
    sb = api.estimate(wl, backend="analytical")
    big = api.estimate(MTTKRPWorkload(), backend="analytical")
    cfg = sb.config  # paper §V-A array: 256x32 words, 52 channels, 20 GHz
    print(f"\npredictive performance model @ paper operating point:")
    print(f"  peak            {peak_petaops(cfg):6.2f} PetaOps (paper: 17)")
    print(f"  sustained       {big.sustained_petaops:6.2f} PetaOps on the paper's 1e6^3 MTTKRP")
    print(f"  this tiny tensor{sb.sustained_petaops:6.2f} PetaOps (reconfig-bound: "
          f"eff={sb.breakdown.reconfig_efficiency:.3f})")
    print(f"  time-to-solution{sb.time_s*1e9:6.1f} ns per MTTKRP")
    counted = api.estimate(wl, backend="psram-scheduled")
    agrees = counted.utilization == sb.utilization
    print(f"  counted cycles  {counted.counts.total_cycles} "
          f"({'agrees with analytical' if agrees else 'diverges'})")
    return {
        "device": str(st_q.factors[0].device), "shape": list(shape), "rank": rank,
        "fit_float": st_f.fit, "iters_float": st_f.iters, "fit_psram": st_q.fit,
        "peak_petaops": peak_petaops(cfg), "sustained_petaops": big.sustained_petaops,
        "tiny_petaops": sb.sustained_petaops,
        "reconfig_efficiency": sb.breakdown.reconfig_efficiency, "time_s": sb.time_s,
        "counted_cycles": counted.counts.total_cycles, "counted_agrees": agrees,
    }


if __name__ == "__main__":
    main()
