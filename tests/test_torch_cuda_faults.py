"""Fault injection, ABFT, degraded mode and the MoE experts' ``psram_einsum``
on a card, held against the same calls on the CPU.

The fault paths drive the executors already on the card (the scheduled
matmul, plain PyTorch; the mesh stream on the ordered fold's quantized chain
route; the group checksums on its fold route), and ``psram_einsum`` is plain
PyTorch held against kernel 2 run on each expert. The kernels build on first
use. These tests carry the ``cuda`` marker and skip without a card; run them
on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda_faults.py

They import nothing of the JAX reference package.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, faults
from repro_torch.core import schedule
from repro_torch.core.photonic_layer import psram_einsum
from repro_torch.faults import abft
from repro_torch.sparse import csf_for_mode, mesh_stream_mttkrp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """Decided when the test runs, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(m, k)).astype(np.float32)),
            torch.tensor(rng.normal(size=(k, n)).astype(np.float32)))


def _sparse(seed=0, shape=(64, 48, 40), nnz=2000, rank=32):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    fs = [rng.normal(size=(s, rank)).astype(np.float32) for s in shape]
    return idx, vals, shape, fs


def _on(device, idx, vals, shape, fs, mode=0):
    csf = csf_for_mode(convert.coo(idx, vals, shape, device=device), mode)
    return csf, tuple(torch.tensor(f, device=device) for f in fs)


PLANS = [faults.FaultPlan(seed=7, stuck_bits=(faults.StuckBit(rate=5e-3),)),
         faults.FaultPlan(seed=12, adc_spikes=(faults.AdcSpike(rate=1e-3, magnitude=0.5),),
                          dead_channels=(faults.DeadChannel((3,)),),
                          laser_drift=faults.LaserDrift(0.99))]


@pytest.mark.parametrize("plan", PLANS, ids=["stuck", "drive"])
@pytest.mark.parametrize("shape", [(8, 64, 96), (60, 600, 100)], ids=["small", "tiled"])
def test_abft_matmul_card_equals_cpu(card, plan, shape):
    """(a, b) The same plan on the card and on the CPU: reports equal field
    for field, ``y`` bit-equal; the armed executor on the card is the CPU's
    bits, chunked or not; ``compiled=True`` under the plan captures no graph
    and gives the eager bits."""
    m, k, n = shape
    x, w = _operands(m, k, n, seed=sum(shape))
    with faults.inject(plan):
        y_cpu, rep_cpu = faults.abft_matmul(x, w)
    with faults.inject(plan):
        y, rep = faults.abft_matmul(x.to(card), w.to(card))
    assert y.is_cuda and torch.equal(y.cpu(), y_cpu)
    assert dataclasses.asdict(rep) == dataclasses.asdict(rep_cpu)
    assert rep.faulty or not plan.stuck_bits
    prog = schedule.build_matmul_program(m, k, n)
    schedule.clear_program_cache()
    with faults.inject(plan):
        cpu = schedule.execute(prog, x, w)
        eager = schedule.execute(prog, x.to(card), w.to(card))
        compiled = schedule.execute(prog, x.to(card), w.to(card), compiled=True)
    assert schedule.captured_graphs() == []
    assert torch.equal(eager.cpu(), cpu) and torch.equal(compiled, eager)
    clean = schedule.execute(prog, x.to(card), w.to(card), compiled=True)
    assert len(schedule.captured_graphs()) == 1 and not torch.equal(clean, eager)
    schedule.clear_program_cache()


def test_abft_matmul_card_chunked_equals_cpu(card, monkeypatch):
    """One K-tile of one N-tile a chunk on the card: the masks' slices land
    on the CPU's cells."""
    x, w = _operands(60, 600, 100, seed=3)
    plan = PLANS[0]
    with faults.inject(plan):
        want = schedule.execute(schedule.build_matmul_program(60, 600, 100), x, w)
    monkeypatch.setattr(schedule, "_CHUNK_BYTES", 1 << 14)
    with faults.inject(plan):
        got = schedule.execute(schedule.build_matmul_program(60, 600, 100), x.to(card),
                               w.to(card))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n_arrays", [1, 4])
def test_abft_mttkrp_card_equals_cpu(card, n_arrays):
    """(c) Clean: nothing detected, ``y`` bit-equal to the mesh call; spiked:
    the card's report equals the CPU's and ``y`` is bit-equal to it."""
    data = _sparse()
    csf_c, fs_c = _on("cpu", *data)
    csf_g, fs_g = _on(card, *data)
    y, rep = faults.abft_mttkrp(csf_g, fs_g, n_arrays=n_arrays, group_fibers=3)
    assert not rep.faulty
    assert torch.equal(y, mesh_stream_mttkrp(csf_g, fs_g, n_arrays=n_arrays))
    plan = faults.FaultPlan(seed=3, adc_spikes=(faults.AdcSpike(magnitude=2.0, rate=0.004),))
    with faults.inject(plan):
        y_cpu, rep_cpu = faults.abft_mttkrp(csf_c, fs_c, n_arrays=n_arrays, group_fibers=3)
    with faults.inject(plan):
        y, rep = faults.abft_mttkrp(csf_g, fs_g, n_arrays=n_arrays, group_fibers=3)
    assert rep.faulty and dataclasses.asdict(rep) == dataclasses.asdict(rep_cpu)
    assert y.is_cuda and torch.equal(y.cpu(), y_cpu)


def test_group_reference_on_the_card_is_np_add_at(card):
    """The group checksums on the card (the ordered fold's fold route; groups
    of 40 root fibers, ~40,000 nonzeros, each a long run with a CTA of its
    own) equal ``np.add.at``'s sequential sums bit for bit."""
    rng = np.random.default_rng(1)
    shape = (50, 300, 400)
    rows = np.repeat(np.arange(50), rng.integers(1, 2000, 50))
    nnz = len(rows)
    idx = np.stack([rows, rng.integers(0, 300, nnz), rng.integers(0, 400, nnz)],
                   1).astype(np.int32)
    data = (idx, rng.normal(size=nnz).astype(np.float32), shape,
            [rng.normal(size=(s, 16)).astype(np.float32) for s in shape])
    csf, fs = _on(card, *data)
    groups = abft._fiber_groups(len(csf.fids[0]), 40)
    c, l1 = abft._group_reference(csf, fs, 0, groups)
    from repro_torch.core.mttkrp import cp_chain_exact

    scaled = cp_chain_exact(csf.expanded_indices(), csf.values, fs, 0).cpu().numpy()
    group_of = np.repeat(np.arange(len(csf.fids[0])), csf.fiber_lengths()) // 40
    want_c, want_l1 = np.zeros_like(c), np.zeros_like(l1)
    np.add.at(want_c, group_of, scaled)
    np.add.at(want_l1, group_of, np.abs(scaled))
    np.testing.assert_array_equal(c, want_c)
    np.testing.assert_array_equal(l1, want_l1)


def test_degraded_mesh_card_equals_cpu(card):
    """(d) Array 1 of 4 lost on the card: ``y`` bit-equal to the clean
    4-array mesh on the card and to the CPU's degraded run; reports equal."""
    data = _sparse(seed=2)
    csf_c, fs_c = _on("cpu", *data, mode=1)
    csf_g, fs_g = _on(card, *data, mode=1)
    y_cpu, rep_cpu = faults.degraded_mesh_mttkrp(csf_c, fs_c, n_arrays=4, dead_arrays=(1,))
    y, rep = faults.degraded_mesh_mttkrp(csf_g, fs_g, n_arrays=4, dead_arrays=(1,))
    assert y.is_cuda and torch.equal(y, mesh_stream_mttkrp(csf_g, fs_g, n_arrays=4))
    assert torch.equal(y.cpu(), y_cpu) and rep == rep_cpu and rep.recovered_rows > 0


@pytest.mark.parametrize("spec,e,c,k,n", [
    ("ecd,edf->ecf", 8, 40, 1024, 512),     # granite-moe's wi/wg: the wgmma route
    ("ecf,efd->ecd", 8, 3, 512, 1024),      # its wo in a decode step: the decode route
    ("ecd,edf->ecf", 4, 24, 1100, 96),      # K past 1040: the float64 contraction
])
def test_psram_einsum_bit_equal_to_kernel2_per_expert(card, spec, e, c, k, n):
    """``psram_einsum`` on the card, expert by expert, bit-equal to kernel 2
    (``psram_matmul``) on that expert's codes, and to the CPU."""
    from repro_torch.core.quantization import quantize_symmetric
    from repro_torch.kernels.psram_matmul import psram_matmul

    rng = np.random.default_rng(k + n)
    w = {"q": torch.tensor(rng.integers(-127, 128, (e, k, n)).astype(np.int8)),
         "scale": torch.tensor(rng.uniform(1e-3, 1e-2, (1, 1, n)).astype(np.float32))}
    x = torch.tensor(rng.standard_normal((e, c, k)).astype(np.float32)).to(torch.bfloat16)
    wg = {name: t.to(card) for name, t in w.items()}
    got = psram_einsum(spec, x.to(card), wg)
    assert got.is_cuda and torch.equal(got.cpu(), psram_einsum(spec, x, w))
    qx, sx = quantize_symmetric(x.to(card), axis=-1)
    before = psram_matmul.launches
    for i in range(e):
        want = psram_matmul(qx[i], wg["q"][i].contiguous(), sx[i].to(torch.float32),
                            wg["scale"][0].contiguous())
        assert torch.equal(got[i], want), i
    assert psram_matmul.launches == before + e
