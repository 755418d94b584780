"""``repro_torch.obs`` on a card: the stopwatch covers the device work
launched inside it and none queued before it, and a span entered during a
CUDA graph capture neither aborts the capture nor synchronizes.

Nothing here is built (no hand-written kernel runs). The tests carry the
``cuda`` marker and skip without a card; run them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda_obs.py

They import nothing of the JAX reference package.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import backends, obs
from repro_torch.core.psram import PsramConfig
from repro_torch.core.schedule import clear_program_cache

pytestmark = pytest.mark.cuda

SLEEP_CYCLES = 200_000_000      # ~0.1 s of spinning on one SM


@pytest.fixture
def card():
    """Decided when the test runs, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean_tracer():
    obs.disable()
    obs.get_tracer().clear()
    yield
    obs.disable()
    obs.get_tracer().clear()


def _sleep_ms(card) -> float:
    """The device time of one ``torch.cuda._sleep(SLEEP_CYCLES)``, by CUDA
    events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(card)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


@pytest.mark.parametrize("tracing", [False, True], ids=["untraced", "traced"])
def test_stopwatch_covers_the_device_work_inside_it(card, tracing):
    """Around a launch that spins the card, the stopwatch reads at least
    the spin's event time; after a spin queued before it, a stopwatch around
    nothing reads far less than the spin."""
    sleep_ms = _sleep_ms(card)
    assert sleep_ms > 20.0
    if tracing:
        obs.enable()
    with obs.stopwatch("test/sleep") as sw:
        torch.cuda._sleep(SLEEP_CYCLES)
    assert 1e3 * sw.duration_s >= 0.9 * sleep_ms
    torch.cuda._sleep(SLEEP_CYCLES)               # queued before the stopwatch
    with obs.stopwatch("test/empty") as empty:
        pass
    assert 1e3 * empty.duration_s < 0.5 * sleep_ms
    names = [e["name"] for e in obs.get_tracer().events()]
    assert names == (["test/sleep", "test/empty"] if tracing else [])


def test_span_inside_a_capture_neither_aborts_it_nor_synchronizes(card, monkeypatch):
    obs.enable()
    x = torch.arange(4096, dtype=torch.float32, device=card)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        y = x * 2                                  # a first run off the capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize(card)

    # torch.cuda.graph synchronizes before its capture begins; none may
    # come while it captures
    while_capturing = []
    real = torch.cuda.synchronize

    def synchronize(*args, **kwargs):
        capturing = torch.cuda.is_current_stream_capturing()
        while_capturing.append(capturing)
        if not capturing:
            real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with obs.span("test/captured", n=4096):
            y = x * 2
    monkeypatch.undo()
    assert not any(while_capturing)
    x.copy_(torch.arange(4096, dtype=torch.float32, device=card) + 1)
    graph.replay()
    torch.cuda.synchronize(card)
    assert torch.equal(y, (torch.arange(4096, device=card, dtype=torch.float32) + 1) * 2)
    (ev,) = obs.get_tracer().events()
    assert ev["name"] == "test/captured"
    assert ev["args"] == {"n": 4096, "capturing": True}


def test_scheduled_matmul_captured_under_tracing(card):
    """``psram-scheduled`` with ``compiled=True`` captures its CUDA graph
    inside the backend's and the executor's spans: the capture succeeds and
    the replay is bit-equal to the eager call."""
    clear_program_cache()
    cfg = PsramConfig()
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((72, 600), generator=gen, device=card)
    w = torch.randn((600, 90), generator=gen, device=card)
    eager = backends.get("psram-scheduled", cfg).matmul(x, w)
    obs.enable()
    graphed = backends.get("psram-scheduled", cfg, compiled=True)
    assert torch.equal(graphed.matmul(x, w), eager)
    assert torch.equal(graphed.matmul(x, w), eager)
    names = [e["name"] for e in obs.get_tracer().events()]
    assert names.count("backend/psram-scheduled/matmul") == 2
    assert names.count("schedule/execute/matmul") == 2
    clear_program_cache()
