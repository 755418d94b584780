"""Multi-array scaling model — the "scalable optical in-memory compute
engine" the paper's §I/§III promise but do not quantify.

One 256×32-word array sustains ~17 PetaOps (perf_model). A real engine tiles
MANY arrays and must feed them: inputs arrive over the optical/electrical
I/O fabric, outputs leave through ADCs and a digital reduction network. This
model adds those two first-order bounds to the paper's per-array model:

  * input feed    — every (j,k) chain consumes one 8-bit word per wavelength
                    cycle per array; total input bandwidth scales with the
                    number of *distinct* operand streams, discounted by
                    operand reuse (an i-block of rows shares the same
                    B/C factor rows — reuse grows with the per-array tile).
  * output drain  — one ADC conversion per (column, wavelength) cycle; the
                    digital reduction tree sums partial A-rows across arrays
                    that share an output tile.

The result is the classic roofline-style saturation: linear scaling while
arrays are compute-bound, flattening once the fabric saturates — and the
model exposes the knee analytically so EXPERIMENTS can report "arrays until
I/O-bound" per fabric generation.

Pure Python, the same arithmetic as the reference module.
"""
from __future__ import annotations

import dataclasses

from .perf_model import MTTKRPWorkload, sustained_mttkrp
from .psram import PsramConfig


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """Engine-level I/O budget shared by all arrays.

    The *on-chip* hyperspectral feed (256 word-lines × 52 λ × 20 GHz ≈
    266 TB/s per array) is satisfied by construction — that is exactly what
    WDM buys. The numbers below are the *engine-level* budget: streaming
    the tensor X in from the engine's local (photonic/HBM-class) memory and
    draining/reducing factor outputs. Factors are resident on-array (the
    paper's stationary-operand assumption), so each streamed tensor byte
    feeds 2R MACs (R CP1 + R CP2 per nonzero)."""

    input_gbps: float = 2_000_000.0    # 2 PB/s aggregate engine memory feed
    output_gbps: float = 200_000.0     # post-ADC digital drain
    reduction_gbps: float = 100_000.0  # cross-array partial-sum network
    output_bytes_per_mac: float = 1e-3 # A writes amortize over nnz/I


@dataclasses.dataclass(frozen=True)
class ScalingPoint:
    arrays: int
    compute_petaops: float      # aggregate sustained compute capability
    input_bound_petaops: float
    output_bound_petaops: float
    delivered_petaops: float
    efficiency: float           # delivered / (arrays * per-array)


def operand_reuse(cfg: PsramConfig, wl: MTTKRPWorkload) -> float:
    """How many MACs each fetched operand byte feeds.

    A stored tile of factor rows is reused for `wavelengths` concurrent
    chains and `rows/rank`-packed segments; the streaming tensor element is
    used once. Reuse = MACs per fetched byte of (factors + tensor)."""
    rank_rows = max(1, min(wl.rank, cfg.rows))
    packed = max(1, cfg.rows // rank_rows)
    return max(1.0, 0.5 * (cfg.wavelengths + packed))


def scale(
    n_arrays: int,
    cfg: PsramConfig | None = None,
    wl: MTTKRPWorkload | None = None,
    fabric: FabricSpec | None = None,
) -> ScalingPoint:
    cfg = cfg or PsramConfig()
    wl = wl or MTTKRPWorkload()
    fabric = fabric or FabricSpec()
    per_array = sustained_mttkrp(cfg, wl).sustained_petaops
    compute = per_array * n_arrays

    # tensor-streaming bound: each fetched nonzero byte feeds 2R MACs
    macs_per_byte = 2.0 * max(wl.rank, 1)
    in_macs = fabric.input_gbps * 1e9 * macs_per_byte
    input_bound = 2.0 * in_macs / 1e15
    out_macs = (fabric.output_gbps + fabric.reduction_gbps) * 1e9 / fabric.output_bytes_per_mac
    output_bound = 2.0 * out_macs / 1e15

    delivered = min(compute, input_bound, output_bound)
    return ScalingPoint(
        arrays=n_arrays,
        compute_petaops=compute,
        input_bound_petaops=input_bound,
        output_bound_petaops=output_bound,
        delivered_petaops=delivered,
        efficiency=delivered / max(compute, 1e-12),
    )


def knee(cfg=None, wl=None, fabric=None, max_arrays: int = 4096) -> int:
    """Smallest array count at which the engine stops scaling linearly."""
    for n in range(1, max_arrays + 1):
        if scale(n, cfg, wl, fabric).efficiency < 0.999:
            return n
    return max_arrays


def sweep(counts=(1, 2, 4, 8, 16, 32, 64, 128, 256), cfg=None, wl=None, fabric=None):
    return [scale(n, cfg, wl, fabric) for n in counts]
