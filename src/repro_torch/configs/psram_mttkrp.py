"""The paper's own workload: MTTKRP / CP-ALS on the pSRAM array (§V).

Not an LM arch — this config parameterizes the tensor-decomposition loop
and the predictive performance model at the paper's operating point.
"""
import dataclasses

from repro_torch.core.perf_model import MTTKRPWorkload
from repro_torch.core.psram import PsramConfig


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    array: PsramConfig = dataclasses.field(default_factory=PsramConfig)
    workload: MTTKRPWorkload = dataclasses.field(default_factory=MTTKRPWorkload)
    rank: int = 32
    adc_bits: int = 16


CONFIG = PaperConfig()
