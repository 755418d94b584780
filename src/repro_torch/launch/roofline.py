"""Roofline arithmetic on the H100, and the counted FLOPs of a traced step.

The reference derives its roofline from compiled HLO text (``analyze_hlo``:
dot FLOPs, bytes and collective bytes, with ``while`` trip counts
propagated). Nothing in the port produces HLO, so that parser has no
counterpart. In its place :func:`count_flops` runs a step once under
``torch.utils.flop_counter.FlopCounterMode`` — on ``meta`` tensors (shapes
only: no memory, no arithmetic) or on the card — and counts the matrix
products' FLOPs (``mm``, ``bmm``, ``addmm``, attention, convolutions: what
the reference counts as ``dot`` and ``convolution``); :func:`analyze_step`
divides that count per chip.
The bytes term is the caller's: per-device argument and output bytes from
the ``dist.sharding`` spec trees, less the donated ones — a lower bound on
HBM traffic. There are no collectives on one device; their term is
``None`` (ROADMAP Queue A item 9c).

Terms (per chip):
    compute_s = dot_flops / PEAK_FLOPS
    memory_s  = bytes / HBM_BW

:func:`model_flops`, :func:`kv_cache_bytes`, :func:`ideal_seconds` and
:func:`_num_attn_layers` are the reference's arithmetic, on the H100's
constants.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.perf_model import H100_BF16_FLOPS_PER_S, H100_HBM_BYTES_PER_S

# hardware constants: an H100 SXM5 80GB (HBM3), its dense bf16 tensor-core
# peak and memory bandwidth (the data sheet's; the kernels' bounds use them)
PEAK_FLOPS = H100_BF16_FLOPS_PER_S      # 989e12 bf16 FLOP/s per card
HBM_BW = H100_HBM_BYTES_PER_S           # 3.35e12 B/s per card


@dataclasses.dataclass
class RooflineResult:
    dot_flops: float = 0.0          # per chip, counted over the traced step
    bytes_essential: float = 0.0    # per chip: arguments + outputs - aliases
    by_op: dict = dataclasses.field(default_factory=dict)   # global FLOPs by aten op

    @property
    def compute_s(self) -> float:
        return self.dot_flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_essential / HBM_BW

    #: no collectives on one device (ROADMAP Queue A item 9c)
    collective_s = None

    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    def summary(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "bytes_essential": self.bytes_essential,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": None,
            "dominant": self.dominant(),
            "by_op": self.by_op,
        }


def count_flops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), flops, by_op)``: the call's result and the
    FLOPs ``FlopCounterMode`` counts in it (globally), with their split by
    aten op."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    by_op = {str(op).removeprefix("aten."): int(n)
             for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return out, int(counter.get_total_flops()), by_op


def analyze_step(flops: float, by_op: dict, *, chips: int, repeat: int = 1,
                 bytes_per_chip: float = 0.0) -> RooflineResult:
    """The roofline of a step whose one traced pass :func:`count_flops`
    counted (``flops`` globally, split ``by_op``): the count times
    ``repeat`` (a microbatch loop's trip count) divided over ``chips``;
    ``bytes_per_chip`` is the memory term's bytes."""
    return RooflineResult(dot_flops=flops * repeat / chips, bytes_essential=bytes_per_chip,
                          by_op={k: v * repeat for k, v in by_op.items()})


def model_flops(cfg, shape_kind: str, seq: int, global_batch: int,
                dec_frac: float = 0.25) -> float:
    """Analytic useful FLOPs (global, whole step) — the 6ND / 2ND yardstick.

    train: 6*N_active*tokens;  prefill: 2*N_active*tokens;
    decode: 2*N_active*batch (one token each) + attention cache-read flops.
    """
    n = cfg.active_param_count()
    if shape_kind == "train":
        tokens = seq * global_batch
        if cfg.family == "encdec":
            tokens = seq * global_batch * (1 + dec_frac) / 2  # enc fwd-only share
        return 6.0 * n * tokens
    if shape_kind == "prefill":
        return 2.0 * n * seq * global_batch
    # decode: matmul flops + attention KV dot flops
    flops = 2.0 * n * global_batch
    if cfg.family != "ssm":
        n_attn = _num_attn_layers(cfg)
        flops += 4.0 * global_batch * seq * n_attn * cfg.n_heads * cfg.head_dim
    return flops


def kv_cache_bytes(cfg, seq: int, global_batch: int) -> float:
    """Global KV-cache (or SSM state) bytes at bf16."""
    if cfg.family == "ssm":
        per = cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4  # f32 state
        return cfg.num_layers * global_batch * per
    n_attn = _num_attn_layers(cfg)
    kv = n_attn * global_batch * seq * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    if cfg.family == "hybrid":
        per = cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        n_ssm = cfg.num_layers - cfg.num_layers // max(cfg.hybrid_attn_period, 1)
        kv += n_ssm * global_batch * per
    return kv


def ideal_seconds(cfg, shape_kind: str, seq: int, global_batch: int,
                  chips: int, model_shards: int = 16) -> float:
    """Roofline target time for one step of this cell.

    train/prefill: compute-bound ideal (MODEL_FLOPS at peak).
    decode: bytes-bound ideal — every device must stream its weight shard
    (TP: 2N/model_shards bytes) plus its share of the KV cache once.
    """
    mf = model_flops(cfg, shape_kind, seq, global_batch)
    ideal_c = mf / chips / PEAK_FLOPS
    if shape_kind != "decode":
        return ideal_c
    w_read = 2.0 * cfg.active_param_count() / model_shards
    kv_read = kv_cache_bytes(cfg, seq, global_batch) / chips
    return max(ideal_c, (w_read + kv_read) / HBM_BW)


def _num_attn_layers(cfg) -> int:
    if cfg.family == "encdec":
        return 2 * cfg.dec_layers  # self + cross per decoder layer at decode
    if cfg.family == "hybrid" and cfg.hybrid_attn_period:
        return cfg.num_layers // cfg.hybrid_attn_period
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers
