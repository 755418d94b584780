"""The host side of the quantized chain route's redesign for Hopper.

The ordered fold's quantized chain route (``kernels.ordered_fold``, the
``psram-stream`` backend's eager path) gives every run of
``CHAIN_LONG_RUN`` nonzeros or more a thread-block cluster, in one launch
with the other runs' CTAs: the list of those runs is found once on the host
and kept with the chain stream (``sparse.stream._chain_stream``), so the
launch never waits for the device to find it. Both quantized routes divide
by the ADC's LSB through its reciprocal, which the host hands them
(``adc_operands``). The kernels themselves are held to their plain versions
on the card (``tests/test_torch_cuda_kernels.py``); the quantized chain
against the JAX reference in ``tests/test_torch_psram_stream.py``.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ordered_fold as of
from repro_torch.sparse import csf_for_mode, powerlaw_coo
from repro_torch.sparse import stream as tstream


def _long_by_hand(seg_ptr) -> list[int]:
    """The runs of ``CHAIN_LONG_RUN`` nonzeros or more, longest first (ties
    in run order), read off the offsets one run at a time."""
    lengths = [int(b - a) for a, b in zip(seg_ptr[:-1], seg_ptr[1:])]
    long = [s for s, n in enumerate(lengths) if n >= of.CHAIN_LONG_RUN]
    return sorted(long, key=lambda s: -lengths[s])


@pytest.mark.parametrize("shape,nnz,mode", [
    ((4, 300, 200), 250_000, 0),       # a few rows: two of them long runs
    ((5, 300, 200), 200_000, 1),       # 300 rows of ~670: none
    ((4, 60, 50, 40), 200_000, 0),     # 4 modes
])
def test_chain_stream_keeps_the_long_runs(shape, nnz, mode):
    """``_chain_stream`` keeps, beside the runs, the list the quantized route
    gives clusters: ``find_long_runs`` at the chain route's threshold on the
    host offsets, int64, longest first; every run is either on it or a
    short CTA's, never both; made once and kept on the CSF."""
    coo = powerlaw_coo(3, shape, nnz=nnz, rank=4, alpha=1.6, device="cpu")
    csf = csf_for_mode(coo, mode)
    kept = tstream._chain_stream(csf)
    seg_ptr, longest, long_runs = kept[1], kept[3], kept[5]
    host = seg_ptr.numpy()
    assert long_runs.dtype == torch.int64 and long_runs.device == seg_ptr.device
    np.testing.assert_array_equal(long_runs.numpy(),
                                  of.find_long_runs(host, of.CHAIN_LONG_RUN - 1))
    assert long_runs.tolist() == _long_by_hand(host)
    lengths = np.diff(host)
    short = set(np.flatnonzero(lengths < of.CHAIN_LONG_RUN).tolist())
    assert short.isdisjoint(long_runs.tolist())
    assert short | set(long_runs.tolist()) == set(range(len(lengths)))
    assert (len(long_runs) > 0) == (longest >= of.CHAIN_LONG_RUN)
    assert tstream._chain_stream(csf)[5] is long_runs


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_long_runs_cover_every_run_once(seed):
    """On offsets with runs just below, at and past the threshold, empty
    runs and ties in length: the long runs are those of ``CHAIN_LONG_RUN``
    nonzeros or more, longest first and ties in run order, and with the
    short ones they cover every run exactly once."""
    rng = np.random.default_rng(seed)
    t = of.CHAIN_LONG_RUN
    lengths = np.r_[rng.integers(0, 3000, 200), [t - 1, t, t, t + 1, 5 * t, 0, 2 * t]]
    rng.shuffle(lengths)
    seg_ptr = np.r_[0, np.cumsum(lengths)].astype(np.int64)
    long = of.chain_long_runs(seg_ptr)
    assert long.tolist() == _long_by_hand(seg_ptr)
    assert sorted(lengths[long].tolist(), reverse=True) == [5 * t, 2 * t, t + 1, t, t]
    short = np.flatnonzero(lengths < t)
    assert np.array_equal(np.sort(np.r_[short, long]), np.arange(len(lengths)))
    assert of.chain_long_runs(seg_ptr[:1]).size == 0          # no run at all


def _nearest_f32(q: Fraction) -> float:
    """The f32 nearest to the rational ``q`` (ties to even), by hand."""
    guess = np.float32(float(q))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(err)
    ties = [c for c, e in zip(cands, err) if e == best]
    return float(min(ties, key=lambda c: int(np.float32(c).view(np.uint32)) & 1))


@pytest.mark.parametrize("bits", range(1, 25))
def test_adc_operands_reciprocal_is_the_ieee_quotient(bits):
    """The LSB the kernels divide by is ``2 * 127² / 2^bits``, exact in f32,
    and the reciprocal the host hands them is the IEEE f32 quotient
    ``1 / lsb``: the f32 nearest to ``2^bits / 32258``."""
    lsb, code_max, rlsb = of.adc_operands(bits)
    assert Fraction(lsb) == Fraction(2 * 127 * 127, 2 ** bits)
    assert float(np.float32(lsb)) == lsb
    assert code_max == 2 ** (bits - 1) - 1
    assert rlsb == _nearest_f32(Fraction(2 ** bits, 2 * 127 * 127))
    assert rlsb == float(np.float32(1.0) / np.float32(lsb))
