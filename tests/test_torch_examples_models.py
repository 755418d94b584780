"""``repro_torch.examples`` held against the reference's ``examples/*.py`` on
the CPU: ``decompose_weights``, ``photonic_offload`` and ``fault_tolerance``
(the method and helpers: ``test_torch_examples.py``)."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_examples import line_with, masked, numbers, pair, run_port  # noqa: E402

# ------------------------------------------------------------ decompose_weights

decompose_weights = pair("decompose_weights", ["--smoke"])


def test_decompose_weights_lines(decompose_weights):
    ref, got, _ = decompose_weights
    assert masked(got) == masked(ref)


def test_decompose_weights_configuration_figures_equal(decompose_weights):
    """The backend line, the tensor's shape, each rank's compression ratio
    and the modeled mode-0 bill depend on configuration alone: equal to the
    printed digit."""
    ref, got, fig = decompose_weights
    for start in ("backend:", "decomposing", "modeled mode-0"):
        assert line_with(got, start) == line_with(ref, start)
    ratios = [ln.split("compression")[1] for ln in ref.splitlines() if "compression" in ln]
    assert [ln.split("compression")[1] for ln in got.splitlines()
            if "compression" in ln] == ratios
    assert fig["device"] == "cpu" and fig["backend"] == "psram-stream"


def test_decompose_weights_fits_meet_the_contract(decompose_weights):
    """Each rank's reported fit is one minus its reconstruction error (the
    printed three digits, 2e-3), in both packages; a larger rank fits
    better; the logits drift is finite and below 1."""
    ref, _, fig = decompose_weights
    ref_ranks = [numbers(ln)[1:3] for ln in ref.splitlines() if ln.strip().startswith("rank")]
    port_ranks = [(r["fit"], r["rel_err"]) for r in fig["ranks"]]
    for ranks in (ref_ranks, port_ranks):
        assert len(ranks) == 2
        for fit, rel in ranks:
            assert abs(fit - (1 - rel)) <= 2e-3
        assert ranks[1][0] > ranks[0][0]
    ref_drift = numbers(line_with(ref, "end-to-end logits drift"))[-1]
    for drift in (ref_drift, fig["logits_drift"]):
        assert np.isfinite(drift) and 0 < drift < 1


def test_decompose_weights_on_eight_arrays(decompose_weights):
    """``--arrays 8`` picks ``psram-mesh``: every fit within 1e-4 of the one
    array's (the MTTKRPs are the stream's bit for bit; the Grams are split
    over the arrays and summed in array order), and the bill the
    reference's ``psram-mesh`` prices for 8 arrays."""
    from repro import backends as jbackends
    from repro.core.perf_model import MeshSparseMTTKRPWorkload as JMesh

    _, _, one = decompose_weights
    _, eight = run_port("decompose_weights", ["--smoke", "--arrays", "8"])
    assert eight["backend"] == "psram-mesh" and eight["n_arrays"] == 8
    assert [r["fit"] for r in eight["ranks"]] == \
        pytest.approx([r["fit"] for r in one["ranks"]], rel=1e-4)
    e, d, ff = eight["shape"]
    want = jbackends.get("psram-mesh", n_arrays=8).cost(JMesh(
        fiber_lengths=np.full((e,), d * ff, dtype=np.int32), rank=16, n_arrays=8))
    assert eight["bill_cycles"] == want.counts.total_cycles
    assert eight["bill_time_s"] == pytest.approx(want.time_s, rel=1e-12)
    assert eight["bill_utilization"] == pytest.approx(want.utilization, rel=1e-12)


# ------------------------------------------------------------- photonic_offload

photonic_offload = pair("photonic_offload")


def _without_projection_err(line: str) -> str:
    return re.sub(r"projection rel_err [-\d.]+", "projection rel_err #", line)


def test_photonic_offload_lines(photonic_offload):
    ref, got, _ = photonic_offload
    assert masked(got) == masked(ref)


def test_photonic_offload_configuration_figures_equal(photonic_offload):
    """The schedule executor's counted cycles, nanoseconds, energy and
    utilization, the decode step's modeled time, and the offload report's
    time, energy and utilization depend on configuration alone: equal to
    the printed digit (the report's projection error is a random draw's)."""
    ref, got, _ = photonic_offload
    for start in ("schedule executor vs per-cycle oracle", "perf model:"):
        assert line_with(got, start) == line_with(ref, start)
    start = "serve offload report"
    assert _without_projection_err(line_with(got, start)) == \
        _without_projection_err(line_with(ref, start))


def test_photonic_offload_contract(photonic_offload):
    """The array's matmul kernel bit-exact against the array oracle
    (max|diff| 0) and the schedule bit-identical to the per-cycle oracle,
    in both packages; the ADC sweep's 12- and 16-bit logits within 0.05 of
    exact with argmax agreement >= 0.9; the projection error within the
    ADC envelope (0.05)."""
    ref, _, fig = photonic_offload
    assert numbers(line_with(ref, "Pallas bit-plane kernel"))[0] == 0.0
    assert fig["kernel_max_abs_diff"] == 0.0 and fig["kernel_lowering"] == "torch"
    assert "bit_identical=True" in ref and fig["schedule_bit_identical"]
    ref_sweep = [numbers(ln) for ln in ref.splitlines() if ln.startswith("ADC")]
    port_sweep = [(s["adc_bits"], s["rel_err"], s["argmax_agreement"]) for s in fig["adc_sweep"]]
    for sweep in (ref_sweep, port_sweep):
        assert [int(s[0]) for s in sweep] == [8, 12, 16]
        for bits, rel, agree in sweep[1:]:
            assert rel < 0.05 and agree >= 0.9, (bits, rel, agree)
    ref_proj = numbers(line_with(ref, "serve offload report"))[-1]
    for proj in (ref_proj, fig["projection_rel_err"]):
        assert 0 < proj <= 0.05
    assert fig["device"] == "cpu"


# -------------------------------------------------------------- fault_tolerance

fault_tolerance = pair("fault_tolerance", ["--smoke"])


def test_fault_tolerance_output_equals_the_references(fault_tolerance):
    """The operands are the reference's numpy draws, so every line is the
    reference's to the printed digit: the corruption, ABFT's tiles,
    retries, fallbacks and recovery cycles, the flagged fiber groups, the
    degraded mesh's rows, cycles and throughput, the scheduler's capacity."""
    ref, got, _ = fault_tolerance
    assert got.splitlines() == ref.splitlines()


def test_fault_tolerance_contract(fault_tolerance):
    """ABFT's corrected outputs exact (rel err 0), degraded mode
    bit-identical, three survivors."""
    _, _, fig = fault_tolerance
    assert fig["matmul_corrected_rel_err"] == 0.0
    assert fig["mttkrp_corrected_rel_err"] == 0.0
    assert fig["degraded_bit_identical"] and fig["survivors"] == 3
    assert fig["matmul_detected"] and fig["mttkrp_flagged"] > 0
    assert fig["device"] == "cpu"
