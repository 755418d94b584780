"""``repro_torch.examples`` held against the reference's ``examples/*.py`` on
the CPU: ``serve_requests``, ``continuous_batching`` and ``train_lm`` (the
method and helpers: ``test_torch_examples.py``). The serve loops run on the
wall clock (arrivals compressed by ``speedup``), so latencies, preemptions
and step counts vary from run to run; the page counts do not."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_examples import line_with, masked, numbers, pair  # noqa: E402

# --------------------------------------------------------------- serve_requests

serve_requests = pair("serve_requests", ["--smoke"])


def test_serve_requests_lines(serve_requests):
    ref, got, _ = serve_requests
    assert masked(got) == masked(ref)
    assert line_with(got, "serving") == line_with(ref, "serving")


def test_serve_requests_contract(serve_requests):
    """Every one of the 24 requests completed or rejected, some completed,
    zero leaked pages, in both packages."""
    ref, _, fig = serve_requests
    completed, rejected, _ = numbers(line_with(ref, "completed"))
    leaked = numbers(line_with(ref, "kv pool:"))[-1]
    for c, r, lk in ((completed, rejected, leaked),
                     (fig["completed"], fig["rejected"], fig["leaked_pages"])):
        assert c + r == 24 and c > 0 and lk == 0
    assert fig["throughput_tok_s"] > 0 and fig["device"] == "cpu"


# ---------------------------------------------------------- continuous_batching

continuous_batching = pair("continuous_batching")


def test_continuous_batching_lines(continuous_batching):
    ref, got, _ = continuous_batching
    assert masked(got) == masked(ref)


def test_continuous_batching_contract(continuous_batching):
    """Both streams account for all 32 requests (completed, rejected or
    failed at the preemption limit) with zero leaked pages, and complete
    some, in both packages (each script asserts the leak itself)."""
    ref, _, fig = continuous_batching
    for arrival in ("poisson", "bursty"):
        assert numbers(line_with(ref, f"[{arrival}"))[0] > 0
        s = fig[arrival]
        assert s["completed"] + s["rejected"] + s["failed"] == 32
        assert s["completed"] > 0 and s["leaked_pages"] == 0
    assert fig["device"] == "cpu"


# --------------------------------------------------------------------- train_lm

STEPS = 30
train_lm = pair("train_lm", ["--steps", str(STEPS)])


def test_train_lm_lines(train_lm):
    ref, got, _ = train_lm
    assert masked(got) == masked(ref)


def test_train_lm_contract(train_lm):
    """The restart resumes at the step trained to, and the loss falls, in
    both packages; the reduced model's size equal to the printed digit."""
    ref, got, fig = train_lm
    assert line_with(got, "training reduced") == line_with(ref, "training reduced")
    resumed, expected = numbers(line_with(ref, "restart test"))
    first, last = numbers(line_with(ref, "loss:"))[:2]
    for r, e, a, b in ((resumed, expected, first, last),
                       (fig["resumed_at"], fig["steps"], fig["loss_first"], fig["loss_last"])):
        assert r == e == STEPS
        assert b < a
    assert fig["device"] == "cpu"
