"""The paper's own workload: MTTKRP / CP-ALS on the pSRAM array (§V).

Not an LM arch — this config parameterizes the tensor-decomposition loop
at the paper's operating point. The reference config also carries the
``MTTKRPWorkload`` descriptor of the predictive model; that field comes with
``core.perf_model``.
"""
import dataclasses

from repro_torch.core.psram import PsramConfig


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    array: PsramConfig = dataclasses.field(default_factory=PsramConfig)
    rank: int = 32
    adc_bits: int = 16


CONFIG = PaperConfig()
