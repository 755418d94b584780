"""Functional simulator of the photonic SRAM (pSRAM) crossbar array (§III).

The array is a 2D crossbar of optical bitcells: 256x256 bits organized as
256 rows x 32 words of 8 bits (§V-A). Word-lines carry WDM-multiplexed,
intensity-encoded inputs (<=52 wavelength channels on GF45SPCLO); each word
multiplies its stored 8-bit value by the input on its word-line, and bit-lines
sum the photocurrent of *identical wavelengths* down each column (§IV-A).

The simulator is bit-exact: every analog step (per-bit product, bit-position
intensity scaling, photocurrent accumulation, ADC) has an integer-arithmetic
identity. Integer sums run in integer tensors or in float64, which holds
every partial sum of 8-bit products exactly, so the same bits come out on
the CPU and on the card.

Wavelength semantics (Fig. 2): a column output is a vector indexed by
wavelength; words on the same column but driven at different wavelengths do
NOT sum together. This is what makes CP 1's Hadamard product possible
(wavelength-interleaved inputs, §IV-C) and what gives the array its
"hyperspectral" throughput multiplier.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .quantization import (
    ADCConfig,
    QMAX,
    WORD_BITS,
    adc_requantize,
    dequantize,
    exact_int_matmul,
    quantize_symmetric,
    to_bitplanes,
)


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


@dataclasses.dataclass
class PsramArray:
    """One programmed array tile, its state held in tensors on ``device``.

    ``store`` writes float weights into the bitcells (quantizing to 8-bit
    words, sign on the differential rail). ``multiply_accumulate`` drives the
    word-lines with intensity-encoded inputs on per-row wavelength channels
    and returns the per-(column, wavelength) accumulated, ADC-digitized
    photocurrents. Operands are moved to ``device`` on the way in.
    """

    config: PsramConfig
    device: torch.device | str = "cuda"
    # programmed state
    sign: torch.Tensor | None = None      # (rows, word_cols) int8
    planes: torch.Tensor | None = None    # (rows, word_cols, WORD_BITS) uint8
    scale: torch.Tensor | None = None     # (1, word_cols) float32 per-column scale

    def store(self, w: torch.Tensor) -> "PsramArray":
        """Program a (rows, word_cols) float matrix into the bitcells."""
        self.config.validate()
        r, c = w.shape
        if r > self.config.rows or c > self.config.word_cols:
            raise ValueError(
                f"matrix {tuple(w.shape)} exceeds array "
                f"{self.config.rows}x{self.config.word_cols}"
            )
        w = w.to(device=self.device, dtype=torch.float32)
        w = torch.nn.functional.pad(w, (0, self.config.word_cols - c, 0, self.config.rows - r))
        q, scale = quantize_symmetric(w, axis=0)
        sign, planes = to_bitplanes(q)
        return dataclasses.replace(self, sign=sign, planes=planes, scale=scale)

    def stored_values(self) -> torch.Tensor:
        """Read back the programmed (dequantized) weights."""
        return dequantize(self._signed_words().to(torch.int8), self.scale)

    def _signed_words(self) -> torch.Tensor:
        """(rows, cols) signed integer word values read from the bit-planes."""
        shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=self.planes.device)
        word_val = (self.planes.to(torch.int32) << shifts).sum(dim=-1, dtype=torch.int32)
        return self.sign.to(torch.int32) * word_val

    def multiply_accumulate(
        self, intensities: torch.Tensor, channel_of_row: torch.Tensor
    ) -> torch.Tensor:
        """Drive the array for one optical cycle.

        Two drive modes share the same physics:

        * per-row channels — intensities (rows,), channel_of_row (rows,):
          each word-line carries one input on its own channel. Rows sharing
          a channel sum together on the bit-line (Fig. 2); rows on distinct
          channels stay separate.
        * WDM batching — intensities (B, rows), channel_of_row (B,) with
          B <= wavelengths and distinct channels: B whole input vectors ride
          the array simultaneously, drive vector b modulated onto channel
          channel_of_row[b] on every word-line (hyperspectral batching,
          §IV-A). Each vector gets its own intensity quantization scale —
          bit-identical to B separate single-vector cycles.

        The channel checks read a host copy of ``channel_of_row`` on every
        call. Returns (word_cols, wavelengths) float32 — per-column,
        per-wavelength ADC-digitized accumulations.
        """
        cfg = self.config
        full_scale = float(QMAX) * float(QMAX) * cfg.rows
        signed_word = self._signed_words()  # (rows, cols)
        intensities = intensities.to(device=signed_word.device, dtype=torch.float32)
        channel_of_row = channel_of_row.to(device=signed_word.device, dtype=torch.int64)
        chans = channel_of_row.cpu().numpy()

        if intensities.ndim == 2:  # WDM batching: one vector per channel
            b = intensities.shape[0]
            if b > cfg.wavelengths:
                raise ValueError(
                    f"{b} drive vectors exceed {cfg.wavelengths} WDM channels"
                )
            if len(np.unique(chans)) != b or chans.max(initial=0) >= cfg.wavelengths:
                raise ValueError(
                    "WDM batching needs one distinct in-range channel per "
                    f"drive vector, got {chans}"
                )
            qx, sx = quantize_symmetric(intensities, axis=1)  # (B, rows), (B, 1)
            # all rows of vector b share channel b, so the bit-line sum is a
            # plain integer dot per (vector, column)
            acc = exact_int_matmul(qx, signed_word)  # (B, cols)
            acc = adc_requantize(acc, cfg.adc, full_scale)
            vals = acc * (sx * self.scale)  # (B, cols)
            out = torch.zeros((cfg.word_cols, cfg.wavelengths), dtype=torch.float32,
                              device=vals.device)
            out[:, channel_of_row] = vals.T
            return out

        if chans.size and (chans.min() < 0 or chans.max() >= cfg.wavelengths):
            raise ValueError(
                "channel_of_row entries must lie in "
                f"[0, {cfg.wavelengths}), got {chans}"
            )
        qx, sx = quantize_symmetric(intensities)
        # per-bit optical product, bit-significance scaling at output encoder
        products = qx.to(torch.int64)[:, None] * signed_word  # (rows, cols) photocurrents
        # photodetector accumulation: segment-sum rows by wavelength channel
        # (integer adds, exact in any order)
        acc = torch.zeros((cfg.word_cols, cfg.wavelengths), dtype=torch.int64,
                          device=products.device)
        acc.index_add_(1, channel_of_row, products.T)
        acc = adc_requantize(acc, cfg.adc, full_scale)
        return acc * (sx * self.scale.reshape(-1, 1))


def matmul_via_array(x: torch.Tensor, w: torch.Tensor,
                     config: PsramConfig | None = None) -> torch.Tensor:
    """Compute ``x @ w`` by tiling it over pSRAM array cycles.

    x: (M, K) float, w: (K, N) float. The schedule (core.schedule): each
    K-tile x N-tile weight block is programmed once, then up to
    ``wavelengths`` rows of x ride the array per optical cycle on distinct
    channels — hyperspectral batching of M (§IV-A).

    Thin wrapper: builds the tile program and runs the vectorized executor,
    which is bit-identical to the per-cycle ``schedule.execute_reference``
    oracle. The result lives on ``x``'s device.
    """
    from repro_torch.backends.base import resolve_config

    from .schedule import build_matmul_program, execute

    cfg = resolve_config(config)
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} @ {tuple(w.shape)}")
    if M == 0 or K == 0 or N == 0:
        return torch.zeros((M, N), dtype=torch.float32, device=x.device)
    return execute(build_matmul_program(M, K, N, cfg), x, w)
