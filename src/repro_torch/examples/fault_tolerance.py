"""End-to-end fault tolerance: inject, detect, recover, degrade.

Walks the `repro_torch.faults` stack on the paper's §V-A operating point:

1. arm a seeded `FaultPlan` (stuck MSB cells in stored tiles) and run a
   matmul through the scheduled executor — the output corrupts;
2. run the same matmul through `abft_matmul` — the checksum columns locate
   the corrupted N-tiles, bounded retry exhausts on the persistent fault,
   and the fault-suppressed fallback corrects the output exactly, with the
   recovery bill in counted cycles;
3. stream a sparse MTTKRP through the mesh with transient ADC spikes —
   `abft_mttkrp`'s fiber-group checksums flag the corrupted row ranges and
   epoch-rolled re-drives clear them;
4. kill one of four arrays (`ArrayLoss`) — `degraded_mesh_mttkrp` recovers
   the lost fiber ranges on survivors bit-identically and re-plans,
   reporting the degraded-throughput fraction the serve scheduler consumes
   via `OffloadScheduler.mark_array_failed`.

The operands are the reference's draws (``numpy.random.default_rng(0)``),
so every figure printed equals the reference's.

Run:  python -m repro_torch.examples.fault_tolerance [--device cpu]
      python -m repro_torch.examples.fault_tolerance --smoke   # asserts every contract
"""
import argparse

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch._device import as_device
from repro_torch.configs.psram_mttkrp import CONFIG
from repro_torch.core.schedule import build_matmul_program, execute
from repro_torch.serve import OffloadScheduler
from repro_torch.sparse.formats import COO, csf_for_mode
from repro_torch.sparse.mesh import mesh_stream_mttkrp


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="smaller operands, asserts every "
                         "detection/recovery contract")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace", metavar="PATH", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the tensors live (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)
    if args.trace:
        obs.enable()
    cfg = CONFIG.array
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.from_numpy(a).to(dev)

    # -- 1. injection corrupts the scheduled executor -----------------------
    m, k, n = (8, 64, 96) if args.smoke else (16, 256, 256)
    x = tensor(rng.normal(size=(m, k)).astype(np.float32))
    w = tensor(rng.normal(size=(k, n)).astype(np.float32))
    prog = build_matmul_program(m, k, n, cfg)
    clean = execute(prog, x, w).cpu().numpy()
    plan = faults.FaultPlan(
        seed=args.seed, stuck_bits=(faults.StuckBit(rate=5e-3),))
    with faults.inject(plan):
        dirty = execute(prog, x, w).cpu().numpy()
    corr = float(np.max(np.abs(dirty - clean)) / np.max(np.abs(clean)))
    print(f"stuck-MSB injection: max rel corruption {corr:.3f}")
    assert corr > 0, "injection had no effect"

    # -- 2. ABFT detects, locates, and corrects -----------------------------
    with faults.inject(plan):
        y, rep = faults.abft_matmul(x, w, cfg)
    err = float(np.max(np.abs(y.cpu().numpy() - clean))
                / np.max(np.abs(clean)))
    print(f"abft_matmul: detected tiles {rep.detected}, "
          f"retries {rep.retries}, fallbacks {rep.fallbacks}, "
          f"recovery {rep.recovery_cycles} cycles "
          f"({rep.recovery_s(cfg):.2e}s), corrected rel err {err:.1e}")
    assert rep.faulty, "ABFT missed the injected corruption"
    assert err <= rep.rel_tol, "corrected output outside the ADC envelope"

    # -- 3. transient spikes on the mesh stream, cleared by re-drive --------
    shape = (64, 48, 40) if args.smoke else (200, 150, 120)
    nnz = 2000 if args.smoke else 20000
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
    coo = COO(indices=tensor(idx.astype(np.int32)),
              values=tensor(rng.normal(size=nnz).astype(np.float32)),
              shape=shape)
    factors = tuple(tensor(rng.normal(size=(s, 32)).astype(np.float32))
                    for s in shape)
    csf = csf_for_mode(coo, 0)
    clean_m = mesh_stream_mttkrp(csf, factors, cfg, n_arrays=1).cpu().numpy()
    spikes = faults.FaultPlan(
        seed=args.seed,
        adc_spikes=(faults.AdcSpike(magnitude=2.0, rate=0.01),))
    with faults.inject(spikes):
        ym, repm = faults.abft_mttkrp(csf, factors, config=cfg, n_arrays=1)
    errm = float(np.max(np.abs(ym.cpu().numpy() - clean_m))
                 / np.max(np.abs(clean_m)))
    print(f"abft_mttkrp: flagged {len(repm.detected)}/{repm.checked} "
          f"fiber groups, recovered {repm.recovered}, "
          f"fallbacks {repm.fallbacks}, corrected rel err {errm:.1e}")
    assert repm.faulty and errm <= repm.rel_tol

    # -- 4. whole-array loss: recover bit-identically, re-plan, re-price ----
    loss = faults.FaultPlan(seed=0, array_loss=(faults.ArrayLoss(2),))
    with faults.inject(loss):
        yd, drep = faults.degraded_mesh_mttkrp(csf, factors, config=cfg,
                                               n_arrays=4)
    bitident = bool((yd.cpu().numpy() == clean_m).all())
    print(f"degraded mesh: lost array {drep.dead}, recovered "
          f"{drep.recovered_rows} rows in {drep.recovery_cycles} cycles, "
          f"throughput {drep.throughput_frac:.2f}x of healthy, "
          f"bit-identical to survivors-only plan: {bitident}")
    assert bitident, "degraded recovery drifted"

    sched = OffloadScheduler(cfg, n_arrays=4)
    survivors = sched.mark_array_failed()
    print(f"serve scheduler: capacity {4} -> {survivors} arrays, "
          "decode prices re-billed on next decision")
    assert survivors == 3

    if args.trace:
        print(f"# wrote {obs.write_trace(args.trace)} trace events")
    print("fault tolerance example OK")
    return {
        "device": str(ym.device), "corruption": corr,
        "matmul_detected": list(rep.detected), "matmul_retries": rep.retries,
        "matmul_fallbacks": rep.fallbacks, "matmul_recovery_cycles": rep.recovery_cycles,
        "matmul_corrected_rel_err": err, "mttkrp_flagged": len(repm.detected),
        "mttkrp_checked": repm.checked, "mttkrp_recovered": repm.recovered,
        "mttkrp_fallbacks": repm.fallbacks, "mttkrp_corrected_rel_err": errm,
        "degraded_dead": list(drep.dead), "degraded_recovered_rows": drep.recovered_rows,
        "degraded_recovery_cycles": drep.recovery_cycles,
        "degraded_throughput_frac": drep.throughput_frac,
        "degraded_bit_identical": bitident, "survivors": survivors,
    }


if __name__ == "__main__":
    main()
