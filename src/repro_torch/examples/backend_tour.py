"""Backend tour: one workload across every registered backend.

The unified registry (``repro_torch.backends``) is the spine of the system:
every way the port can run an MTTKRP — exact float, the per-cycle array
oracle, the vectorized tile schedule, the nonzero-streaming sparse schedule,
the hand-written Hopper kernels, the closed-form §V model — answers to one
protocol (``mttkrp`` / ``matmul`` / ``cost`` / ``capabilities``) behind one
name. This tour runs the *same* MTTKRP through all of them via
``repro_torch.api`` and prints:

1. the execution table — wall-clock and relative error vs ``"exact"`` for
   every executable backend (each within its documented ``rel_tol``; on the
   card the ``"hopper"`` row runs the hand-written kernels, on the CPU their
   plain versions);
2. the drift table — ``obs.drift_report`` pricing each workload through the
   analytical backend *and* the counted schedules, on both the dense
   §V-A-style descriptor and a power-law sparse workload: the
   estimate==measured contract as one audited table (drift is exactly 0 on
   the paper's operating point).

Run:  python -m repro_torch.examples.backend_tour [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import api, backends, obs
from repro_torch._device import as_device
from repro_torch.core.perf_model import MTTKRPWorkload, SparseMTTKRPWorkload
from repro_torch.sparse import csf_for_mode, powerlaw_coo


def normal(seed: int, shape, device) -> torch.Tensor:
    """Standard-normal f32 draws from a CPU generator seeded with ``seed``
    (the same draws on every device), moved to ``device``."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen).to(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the tensors live (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)

    shape, rank = (48, 40, 32), 8
    x = normal(0, shape, dev)
    fs = tuple(normal(d + 1, (s, rank), dev) for d, s in enumerate(shape))
    want = api.mttkrp(x, fs, 0, backend="exact")

    rows = {}
    print(f"one dense MTTKRP {shape} rank {rank}, every registered backend:")
    print(f"{'backend':18s} {'executes':9s} {'ms':>8s} {'rel_err':>8s}  tol")
    for name in backends.list_backends():
        be = backends.get(name)
        caps = be.capabilities()
        if not caps.executes:
            print(f"{name:18s} {'cost-only':9s} {'-':>8s} {'-':>8s}  -")
            continue
        sync(dev)
        t0 = time.perf_counter()
        got = be.mttkrp(x, fs, 0)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        rel = rel_err(got, want)
        assert rel <= max(caps.rel_tol, 1e-5), (name, rel)
        print(f"{name:18s} {'yes':9s} {ms:8.1f} {rel:8.4f}  {caps.rel_tol:g}")
        rows[name] = {"ms": ms, "rel_err": rel, "rel_tol": caps.rel_tol,
                      "device": str(got.device)}

    # ---- the drift table: analytical estimate vs counted schedule ----------
    # obs.drift_report prices each workload through the analytical closed
    # form AND every counted backend that can bill it, and reports the
    # relative disagreement — the estimate==measured contract, audited.
    coo = powerlaw_coo(7, (600, 500, 400), nnz=40_000, rank=4, alpha=1.2,
                       device=dev)
    csf = csf_for_mode(coo, 0)
    report = obs.drift_report(workloads={
        # the paper's dense §V-A descriptor (1e6^3, R=32), checked against
        # both scheduled counters
        "mttkrp/dense/sVA": MTTKRPWorkload(),
        # this tour's own sparse tensor, checked against the stream schedule
        "mttkrp/sparse/powerlaw": (
            SparseMTTKRPWorkload(fiber_lengths=csf.fiber_lengths(),
                                 rank=rank),
            ("psram-stream",),
        ),
    })
    print(f"\nanalytical-vs-counted drift (sparse nnz={coo.nnz}):")
    print(report.table())
    print(f"max drift: {report.max_drift:.3e} "
          f"{'(estimate == measured, exactly)' if report.max_drift == 0 else ''}")

    # and the streamed engine really produces the exact segment-sum answer
    sfs = fs_for(coo.shape, rank, dev)
    got = api.execute(api.MTTKRPProblem(csf, sfs, 0), backend="psram-stream")
    exact = api.execute(api.MTTKRPProblem(csf, sfs, 0), backend="exact")
    rel = rel_err(got, exact)
    print(f"\npsram-stream vs exact on the sparse tensor: rel_err={rel:.4f} "
          "(ADC quantization envelope)")
    return {
        "device": str(got.device), "rows": rows, "sparse_nnz": coo.nnz,
        "drift_rows": [(r.workload, r.backend, r.drift) for r in report.rows],
        "max_drift": report.max_drift, "sparse_rel_err": rel,
    }


def fs_for(shape, rank, device):
    return tuple(normal(11 + d, (s, rank), device) for d, s in enumerate(shape))


if __name__ == "__main__":
    main()
