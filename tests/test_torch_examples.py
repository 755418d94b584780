"""``repro_torch.examples`` held against the reference's ``examples/*.py`` on
the CPU: the paper's main path (``quickstart``, ``backend_tour``,
``sparse_decompose``). ``test_torch_examples_models.py`` and
``test_torch_examples_serve.py`` hold the other six with the helpers here.

Each reference script is run from ``examples/`` by path, as its ``__main__``
(``sys.argv`` set, stdout captured), at the size the reference's CI runs it
(``--smoke`` where the script has one), and each port example's ``main``
with the same flags and ``--device cpu``, once a module. Then:

* the same lines in the same order once every number is masked (the names
  ``pallas`` / the Pallas kernel aside: the port's ``hopper`` / kernel 2);
* figures that depend only on configuration equal, to the printed digit
  or, where the port's draws feed them, the reference's function applied to
  the port's data;
* figures from random draws held to the contract the example states, on
  both packages' outputs (the port's from the returned dict, the
  reference's parsed from its lines). The draws cannot match: ``jax.random``
  and ``torch.Generator`` differ. Wall times are not compared.
"""
import contextlib
import importlib
import io
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:e[-+]?\d+)?")
# the reference's names for what the port runs on the card in their place
RENAMES = (("Pallas bit-plane kernel", "kernel 2 (torch)"), ("pallas ", "hopper "))


def run_reference(name: str, argv=()) -> str:
    """stdout of ``examples/<name>.py`` run as ``__main__`` with ``argv``."""
    path = EXAMPLES / f"{name}.py"
    buf, saved = io.StringIO(), sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


def run_port(name: str, argv=()) -> tuple[str, dict]:
    """stdout and figures of ``repro_torch.examples.<name>.main`` on the CPU."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        figures = mod.main([*argv, "--device", "cpu"])
    return buf.getvalue(), figures


def masked(text: str, renames=RENAMES) -> list[str]:
    """Non-empty lines, every number ``#`` with the blanks around it dropped
    (a field's padding depends on the number's width), other runs of blanks
    one space."""
    out = []
    for line in text.splitlines():
        for old, new in renames:
            line = line.replace(old, new)
        line = re.sub(r" *# *", "#", " ".join(NUMBER.sub("#", line).split()))
        if line:
            out.append(line)
    return out


def numbers(line: str) -> list[float]:
    return [float(v) for v in NUMBER.findall(line)]


def line_with(text: str, start: str) -> str:
    """The one line of ``text`` that starts with ``start`` (blanks trimmed)."""
    hits = [ln for ln in text.splitlines() if ln.strip().startswith(start)]
    assert len(hits) == 1, (start, hits)
    return hits[0].strip()


def after(text: str, start: str) -> list[str]:
    """The lines of ``text`` from the one starting with ``start`` on."""
    lines = [ln.strip() for ln in text.splitlines()]
    i = [j for j, ln in enumerate(lines) if ln.startswith(start)]
    assert len(i) == 1, (start, i)
    return [ln for ln in lines[i[0]:] if ln]


def pair(name: str, argv=()):
    """A module fixture: both packages' runs of one example."""
    @pytest.fixture(scope="module")
    def runs():
        ref = run_reference(name, argv)
        got, figures = run_port(name, argv)
        return ref, got, figures
    return runs


# ------------------------------------------------------------------ quickstart

quickstart = pair("quickstart")


def test_quickstart_lines(quickstart):
    ref, got, _ = quickstart
    assert masked(got) == masked(ref)


def test_quickstart_model_figures_equal(quickstart):
    """The §V model's lines depend on configuration alone: equal to the
    printed digit (peak, sustained, the tiny tensor's PetaOps and
    efficiency, time to solution, counted cycles and their agreement)."""
    ref, got, fig = quickstart
    start = "predictive performance model"
    assert after(got, start) == after(ref, start)
    assert fig["counted_agrees"] and fig["device"] == "cpu"


def test_quickstart_fits_meet_the_contract(quickstart):
    """Exact CP-ALS reaches fit >= 0.98 on the rank-4 tensor in both
    packages, and the pSRAM run stays within 0.02 of it (the printed
    quantization gap)."""
    ref, _, fig = quickstart
    ref_float = numbers(line_with(ref, "float CP-ALS"))[0]
    ref_psram = numbers(line_with(ref, "pSRAM CP-ALS"))[0]
    for fit_float, fit_psram in ((ref_float, ref_psram), (fig["fit_float"], fig["fit_psram"])):
        assert fit_float >= 0.98
        assert abs(fit_float - fit_psram) <= 0.02


# ---------------------------------------------------------------- backend_tour

backend_tour = pair("backend_tour")


def _tour_rows(text: str) -> dict:
    rows = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[1] == "yes":
            rows[parts[0]] = {"rel_err": float(parts[3]), "rel_tol": float(parts[4])}
    return rows


def test_backend_tour_lines(backend_tour):
    ref, got, _ = backend_tour
    assert masked(got) == masked(ref)


def test_backend_tour_every_row_within_its_rel_tol(backend_tour):
    """Each executing backend's rel_err within its ``rel_tol`` (1e-5 for the
    exact ones), in both packages; the same rows, ``hopper`` where the
    reference has ``pallas``."""
    ref, _, fig = backend_tour
    ref_rows = _tour_rows(ref)
    assert set(fig["rows"]) == {"hopper" if n == "pallas" else n for n in ref_rows}
    for rows in (ref_rows, fig["rows"]):
        for name, row in rows.items():
            assert row["rel_err"] <= max(row["rel_tol"], 1e-5), (name, row)
    assert all(r["device"] == "cpu" for r in fig["rows"].values())


def test_backend_tour_drift_table(backend_tour):
    """The dense §V-A rows equal to the printed digit (configuration only);
    every drift 0 in both packages; the streamed sparse MTTKRP within the
    ADC envelope (0.05) of exact in both."""
    ref, got, fig = backend_tour
    dense = [ln.strip() for ln in ref.splitlines() if ln.startswith("mttkrp/dense/sVA")]
    assert len(dense) == 2
    assert [ln.strip() for ln in got.splitlines() if ln.startswith("mttkrp/dense/sVA")] == dense
    assert numbers(line_with(ref, "max drift:"))[0] == 0.0
    assert fig["max_drift"] == 0.0 and all(d == 0.0 for _, _, d in fig["drift_rows"])
    assert numbers(line_with(ref, "psram-stream vs exact"))[-1] <= 0.05
    assert fig["sparse_rel_err"] <= 0.05


# ------------------------------------------------------------ sparse_decompose

sparse_decompose = pair("sparse_decompose")


def test_sparse_decompose_lines(sparse_decompose):
    ref, got, _ = sparse_decompose
    assert masked(got) == masked(ref)


def test_sparse_decompose_price_is_the_references_on_the_ports_tensor(sparse_decompose):
    """The streamed schedule's counted cycles, energy and sustained model
    equal the reference's functions applied to the port's fiber lengths,
    and the 8-array split holds every nonzero."""
    from repro.core.perf_model import SparseMTTKRPWorkload, sustained_mttkrp
    from repro.core.psram import PsramConfig
    from repro.core.schedule import count_cycles, program_energy
    from repro.sparse import build_stream_program
    from repro_torch.sparse import csf_for_mode, powerlaw_coo

    _, _, fig = sparse_decompose
    coo = powerlaw_coo(0, (600, 500, 400), nnz=60_000, rank=4, alpha=1.2, device="cpu")
    lengths = np.asarray(csf_for_mode(coo, 0).fiber_lengths())
    assert int(lengths.sum()) == fig["nnz"] == sum(fig["loads"])
    cfg = PsramConfig()
    prog = build_stream_program(lengths, 16, cfg)
    c = count_cycles(prog)
    assert (fig["total_cycles"], fig["write_cycles"], fig["compute_cycles"]) == \
        (c.total_cycles, c.write_cycles, c.compute_cycles)
    assert fig["energy_j"] == pytest.approx(program_energy(prog).total_j, rel=1e-12)
    sb = sustained_mttkrp(cfg, SparseMTTKRPWorkload(fiber_lengths=lengths, rank=16))
    assert fig["sustained_petaops"] == pytest.approx(sb.sustained_petaops, rel=1e-12)


def test_sparse_decompose_fits_meet_the_contract(sparse_decompose):
    """Both fits computed exactly: the quantized engine's within 0.01 of the
    float one, in both packages; the split's imbalance at least 1."""
    ref, _, fig = sparse_decompose
    line = line_with(ref, "CP-ALS fit:")
    ref_float = float(re.search(r"float=([-\d.]+)", line).group(1))
    ref_psram = float(re.search(r"ADC=([-\d.]+)", line).group(1))
    for fit_float, fit_psram in ((ref_float, ref_psram), (fig["fit_float"], fig["fit_psram"])):
        assert 0.0 < fit_float < 1.0
        assert abs(fit_float - fit_psram) <= 0.01
    assert fig["imbalance"] >= 1.0 and fig["device"] == "cpu"
