"""The drift auditor: estimate vs measured, continuously observable.

The repo's standing contract is **estimate == measured**: the closed-form
§V model (``perf_model.sustained_mttkrp`` / ``stream_counts``) and the
counted schedule (``count_cycles`` over the programs that actually execute)
derive from the same schedule and must agree — exactly, on the §V-A
operating point. :func:`drift_report` turns that contract into an artifact:
one row per (workload, counted backend) comparing the analytical price
against the counted cycles (and, when the caller measured one, wall-clock),
with the maximum relative drift surfaced for CI gating.

Three comparison axes per row:

* **utilization / sustained PetaOps** — the §V breakdown terms, defined for
  every workload kind (the dense closed form has no cycle count; this is
  its comparison axis).
* **total cycles** — compared when both sides count a schedule (sparse
  workloads: ``stream_counts`` is defined to equal
  ``count_cycles(build_stream_program(...))`` field for field).
* **wall-clock** — informational, joined from the caller's measurements;
  never part of the gated drift (wall time includes dispatch, host work and
  the card's own speed, which the cycle model deliberately excludes).

The default set is the reference's four workloads: the dense §V-A
operating point, a dense matmul, and the sparse stream on one array and on a
4-array mesh (counted by the ``"psram-mesh"`` backend).

CLI: ``python -m repro_torch.obs.drift [--json out.json] [--fail-on-drift]``
— runs the default §V-A workload set and, with ``--fail-on-drift``, exits 1
if any analytical-vs-counted drift exceeds 0.
"""
from __future__ import annotations

import dataclasses
import json


def _rel(a: float, b: float) -> float:
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


@dataclasses.dataclass(frozen=True)
class DriftRow:
    """One (workload, counted backend) comparison against ``"analytical"``."""

    workload: str
    backend: str
    analytical_util: float
    counted_util: float
    analytical_petaops: float
    counted_petaops: float
    analytical_cycles: int | None
    counted_cycles: int | None
    wall_s: float | None
    drift: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    rows: tuple

    @property
    def max_drift(self) -> float:
        return max((r.drift for r in self.rows), default=0.0)

    def table(self) -> str:
        """The report as an aligned text table (the printed artifact)."""
        head = (f"{'workload':<24} {'backend':<16} {'util est':>9} "
                f"{'util cnt':>9} {'PetaOps est':>12} {'PetaOps cnt':>12} "
                f"{'cycles cnt':>12} {'wall s':>9} {'drift':>8}")
        lines = [head, "-" * len(head)]
        for r in self.rows:
            cyc = "-" if r.counted_cycles is None else f"{r.counted_cycles:.3e}"
            wall = "-" if r.wall_s is None else f"{r.wall_s:.3f}"
            lines.append(
                f"{r.workload:<24} {r.backend:<16} {r.analytical_util:>9.4f} "
                f"{r.counted_util:>9.4f} {r.analytical_petaops:>12.4f} "
                f"{r.counted_petaops:>12.4f} {cyc:>12} {wall:>9} "
                f"{r.drift:>8.1e}")
        lines.append(f"max analytical-vs-counted drift: {self.max_drift:.3e}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"rows": [r.to_dict() for r in self.rows],
                "max_drift": self.max_drift}


# deterministic skewed fiber distribution for the default sparse workloads —
# mixes mega-fibers with singletons so blocks exercise both occupancy regimes
_DEFAULT_FIBERS = tuple((37 * i) % 613 + 1 for i in range(1, 257))


def default_workloads() -> dict:
    """The §V-A audit set: the paper's dense operating point, a dense
    matmul, and the streaming sparse schedule on one array and on a 4-array
    mesh — every workload kind the estimate==measured contract covers."""
    from repro_torch.backends.workload import MatmulWorkload
    from repro_torch.core.perf_model import (
        MeshSparseMTTKRPWorkload,
        MTTKRPWorkload,
        SparseMTTKRPWorkload,
    )

    return {
        "mttkrp/dense/sVA": MTTKRPWorkload(),
        "matmul/512x512x128": MatmulWorkload(m=512, k=512, n=128),
        "mttkrp/sparse/stream": SparseMTTKRPWorkload(
            fiber_lengths=_DEFAULT_FIBERS),
        "mttkrp/sparse/mesh4": MeshSparseMTTKRPWorkload(
            fiber_lengths=_DEFAULT_FIBERS, n_arrays=4),
    }


def _counted_backends(workload) -> tuple[str, ...]:
    """Which scheduled backends count this workload kind's schedule."""
    from repro_torch.backends.workload import MatmulWorkload
    from repro_torch.core.perf_model import (
        MeshSparseMTTKRPWorkload,
        SparseMTTKRPWorkload,
    )

    if isinstance(workload, MatmulWorkload):
        return ("psram-scheduled",)
    if isinstance(workload, MeshSparseMTTKRPWorkload):
        return ("psram-mesh",)
    if isinstance(workload, SparseMTTKRPWorkload):
        return ("psram-stream",)
    return ("psram-scheduled", "psram-oracle")


def drift_report(workloads=None, config=None, wall_times=None) -> DriftReport:
    """Audit estimate-vs-measured over ``workloads``.

    ``workloads`` maps row name → workload descriptor, or → ``(descriptor,
    (backend names...))`` to pick the counted backends explicitly (default:
    every scheduled backend that prices that workload kind). ``wall_times``
    optionally maps row name → measured seconds, joined informationally.
    Returns a :class:`DriftReport`; the §V-A default set must report
    ``max_drift == 0.0`` (tests/test_torch_obs.py).
    """
    from repro_torch import api

    from .tracer import span

    if workloads is None:
        workloads = default_workloads()
    wall_times = wall_times or {}
    rows = []
    with span("obs/drift/report", workloads=len(workloads)):
        for name, spec in workloads.items():
            if isinstance(spec, tuple) and len(spec) == 2 \
                    and isinstance(spec[1], (tuple, list)):
                wl, backends = spec
            else:
                wl, backends = spec, None
            if backends is None:
                backends = _counted_backends(wl)
            est = api.estimate(wl, backend="analytical", config=config)
            for bname in backends:
                cnt = api.estimate(wl, backend=bname, config=config)
                drift = max(
                    _rel(est.utilization, cnt.utilization),
                    _rel(est.sustained_petaops, cnt.sustained_petaops),
                )
                a_cycles = (None if est.counts is None
                            else int(est.counts.total_cycles))
                c_cycles = (None if cnt.counts is None
                            else int(cnt.counts.total_cycles))
                if a_cycles is not None and c_cycles is not None:
                    drift = max(drift, _rel(a_cycles, c_cycles))
                rows.append(DriftRow(
                    workload=name,
                    backend=bname,
                    analytical_util=est.utilization,
                    counted_util=cnt.utilization,
                    analytical_petaops=est.sustained_petaops,
                    counted_petaops=cnt.sustained_petaops,
                    analytical_cycles=a_cycles,
                    counted_cycles=c_cycles,
                    wall_s=wall_times.get(name),
                    drift=drift,
                ))
    return DriftReport(rows=tuple(rows))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="estimate-vs-measured drift audit (§V-A workload set)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the report as JSON")
    ap.add_argument("--fail-on-drift", action="store_true",
                    help="exit 1 if any analytical-vs-counted drift > 0")
    args = ap.parse_args(argv)
    report = drift_report()
    print(report.table())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2)
        print(f"wrote {args.json}")
    if args.fail_on_drift and report.max_drift > 0.0:
        print("FAIL: analytical-vs-counted drift exceeds 0 on the §V-A "
              "operating point")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
