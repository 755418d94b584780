"""Physical configuration of one photonic SRAM (pSRAM) crossbar array (§III).

The array is a 2D crossbar of optical bitcells: 256x256 bits organized as
256 rows x 32 words of 8 bits (§V-A). Word-lines carry WDM-multiplexed,
intensity-encoded inputs (<=52 wavelength channels on GF45SPCLO).

Only :class:`PsramConfig` is ported so far; the functional array simulator
(``PsramArray``, ``matmul_via_array``) of the reference module is still to
come.
"""
from __future__ import annotations

import dataclasses

from .quantization import ADCConfig, WORD_BITS


@dataclasses.dataclass(frozen=True)
class PsramConfig:
    """Physical configuration of one pSRAM array tile (§V-A defaults)."""

    rows: int = 256                 # word-lines
    word_cols: int = 32             # words per row (256 bits / 8-bit words)
    wavelengths: int = 52           # WDM channels available (O-band, 45SPCLO)
    frequency_ghz: float = 20.0     # write/reconfigure rate of the latch
    adc: ADCConfig = dataclasses.field(default_factory=ADCConfig)

    @property
    def bits_per_row(self) -> int:
        return self.word_cols * WORD_BITS

    @property
    def words(self) -> int:
        return self.rows * self.word_cols

    def validate(self) -> None:
        if self.wavelengths < 1:
            raise ValueError("need at least one wavelength channel")
        if self.wavelengths > 52:
            raise ValueError("GF45SPCLO O-band comb provides at most 52 channels")
        if self.rows < 1 or self.word_cols < 1:
            raise ValueError("degenerate array")
