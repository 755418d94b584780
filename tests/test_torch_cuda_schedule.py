"""The tile-schedule executor on a card: the CUDA graph's replay against the
eager executor, and the card against the CPU.

The executor is plain PyTorch (batched contractions and elementwise ops, no
hand-written kernel), so these tests build nothing. They carry the ``cuda``
marker and skip without a card; run them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda_schedule.py

They import nothing of the JAX reference package.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import backends
from repro_torch.core.psram import PsramConfig
from repro_torch.core import schedule
from repro_torch.core.schedule import (build_matmul_program, captured_graphs, clear_program_cache,
                                       execute)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """Decided when the test runs, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operands(m, k, n, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((m, k), generator=gen).to(device),
            torch.randn((k, n), generator=gen).to(device))


CASES = [((104, 1024, 2048), {}), ((77, 1043, 131), {}), ((3, 20, 5), dict(rows=16, word_cols=8,
                                                                             wavelengths=4)),
         ((5, 1200, 6), dict(rows=1100, word_cols=4, wavelengths=3))]


@pytest.mark.parametrize("shape,geometry", CASES, ids=["mid", "ragged", "small", "float64"])
def test_executor_on_the_card_bit_equal_to_the_cpu(card, shape, geometry):
    """The eager executor on the card gives the CPU's bits, and so does the
    CUDA graph's replay (``compiled=True``), call after call and after the
    graph is released and captured again."""
    m, k, n = shape
    prog = build_matmul_program(m, k, n, PsramConfig(**geometry))
    x, w = _operands(m, k, n, seed=m + k + n)
    cpu = execute(prog, x, w)
    xc, wc = x.to(card), w.to(card)
    eager = execute(prog, xc, wc)
    assert eager.is_cuda and torch.equal(eager.cpu(), cpu)
    for _ in range(2):
        graph = execute(prog, xc, wc, compiled=True)
        assert graph.is_cuda and torch.equal(graph, eager)
        assert torch.equal(execute(prog, xc, wc, compiled=True), eager)
        clear_program_cache()
    # new operands through the same captured graph
    x2, w2 = _operands(m, k, n, seed=1, device=card)
    assert torch.equal(execute(prog, x2, w2, compiled=True), execute(prog, x2, w2))
    clear_program_cache()


def test_oracle_and_dense_mapping_on_the_card(card):
    """``psram-oracle``'s per-cycle matmul on the card is the executor's
    bits; the dense ``psram-scheduled`` MTTKRP on the card is the CPU's."""
    x, w = _operands(60, 300, 45, seed=4, device=card)
    assert torch.equal(backends.get("psram-oracle").matmul(x, w),
                       backends.get("psram-scheduled").matmul(x, w))
    gen = torch.Generator().manual_seed(9)
    t = torch.randn((20, 12, 30), generator=gen)
    fs = [torch.randn((s, 8), generator=gen) for s in t.shape]
    be = backends.get("psram-scheduled")
    for mode in range(3):
        got = be.mttkrp(t.to(card), [f.to(card) for f in fs], mode)
        assert got.is_cuda and torch.equal(got.cpu(), be.mttkrp(t, fs, mode))


def test_captured_graphs_release_past_their_byte_budget(card, monkeypatch):
    """With room for one graph, capturing a second releases the first: the
    card's allocated memory falls by at least the first graph's static
    operands, only the newest graph stays held, and the released executor
    captures again on its next call with the same bits."""
    clear_program_cache()
    monkeypatch.setattr(schedule, "_GRAPH_BYTES", 0)
    big, small = (256, 2048, 4096), (8, 64, 32)
    x, w = _operands(*big[:2], big[2], seed=3, device=card)
    prog = build_matmul_program(*big)
    first = execute(prog, x, w, compiled=True)
    torch.cuda.synchronize()
    held_big = torch.cuda.memory_allocated(card)
    assert [(s, nbytes >= 4 * (big[0] * big[1] + big[1] * big[2]))
            for s, _, nbytes in captured_graphs()] == [(big, True)]
    xs, ws = _operands(*small[:2], small[2], seed=4, device=card)
    execute(build_matmul_program(*small), xs, ws, compiled=True)
    torch.cuda.synchronize()
    assert [s for s, _, _ in captured_graphs()] == [small]
    assert torch.cuda.memory_allocated(card) \
        <= held_big - 4 * (big[0] * big[1] + big[1] * big[2])
    again = execute(prog, x, w, compiled=True)
    assert torch.equal(again, first) and torch.equal(again, execute(prog, x, w))
    assert [s for s, _, _ in captured_graphs()] == [big]
    clear_program_cache()
    assert captured_graphs() == []
