"""The paged serve loop on a card, held against the same loop on the CPU.

The loop's gather, step and scatter are plain PyTorch indexing around the
model; with ``psram_projections`` every projection goes through kernel 2
(``psram_matmul``), which builds on first use. These tests carry the
``cuda`` marker and skip without a card; run them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda_serve_loop.py

They import nothing of the JAX reference package. What is compared: the
schedule (prefills, steps, preemptions, batch sizes, modeled cycles) equal,
since it depends on the stream and the page tables alone; the greedy tokens
at least 90% equal (f32 sums in the card's order can flip a near-tie, and a
flipped token changes the rest of its request); kernel 2 bit-equal to its
plain version on every call of a paged prefill and a paged decode step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import transformer
from repro_torch.models.registry import get_config
from repro_torch.serve import ServeLoop, ServeLoopConfig, TrafficConfig, traffic
from repro_torch.serve.loop import _Active

pytestmark = pytest.mark.cuda

LOOP = dict(max_batch=4, num_pages=24, page_size=8, speedup=1e9)


@pytest.fixture
def card():
    """Decided when the test runs, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("pressure", [False, True], ids=["no_pressure", "pressure"])
def test_loop_card_equals_cpu(card, pressure):
    cfg = get_config("granite_8b").reduced()
    params = transformer.init(0, cfg, device="cpu")
    lc = dict(LOOP, num_pages=8, page_size=4) if pressure else LOOP
    tc = TrafficConfig(n_requests=5, seed=3, rate_rps=500.0, prompt_min=4, prompt_max=4,
                       decode_min=20, decode_max=20, vocab_size=cfg.vocab_size) if pressure \
        else TrafficConfig(n_requests=16, seed=1, rate_rps=60.0, prompt_min=2, prompt_max=24,
                           decode_min=2, decode_max=12, vocab_size=cfg.vocab_size)
    cpu = ServeLoop(cfg, params, ServeLoopConfig(**lc), device="cpu").run_sync(tc)
    loop = ServeLoop(cfg, _tree_to(params, card), ServeLoopConfig(**lc), device=card)
    assert loop.slab.device.type == card.type
    got = loop.run_sync(tc)
    assert (got.n_prefills, got.n_steps, got.preemptions, got.leaked_pages) == \
        (cpu.n_prefills, cpu.n_steps, cpu.preemptions, 0)
    for key in ("batch", "modeled_s", "makespan_cycles"):
        assert [o[key] for o in got.offload] == [o[key] for o in cpu.offload]
    if pressure:
        assert got.preemptions >= 1
    same = total = 0
    for g, c in zip(got.records, cpu.records):
        assert g.n_generated == c.n_generated
        same += sum(a == b for a, b in zip(g.tokens, c.tokens))
        total += len(c.tokens)
    assert same >= 0.9 * total, (same, total)


def test_paged_psram_kernel2_equals_plain(card):
    """pSRAM granite (stored int8 words) in the loop: every projection of a
    paged prefill at bucket 8 (kernel 2's decode route), at bucket 32 (a
    tiled route) and of one paged decode step is bit-equal to kernel 2's
    plain version on the operands it was given."""
    import repro_torch.core.photonic_layer as photonic
    from repro_torch.kernels.psram_matmul import psram_matmul_torch

    cfg = dataclasses.replace(get_config("granite_8b").reduced(), psram_projections=True,
                              psram_stored_int8=True)
    loop = ServeLoop(cfg, None, ServeLoopConfig(**LOOP), device=card)
    launch, calls = photonic.psram_matmul, []

    def record(qx, qw, sx, sw, adc_bits=16, saturate=True):
        out = launch(qx, qw, sx, sw, adc_bits=adc_bits, saturate=saturate)
        calls.append((qx, qw, sx, sw, adc_bits, out))
        return out

    rng = np.random.default_rng(5)
    rows = []
    photonic.psram_matmul = record
    try:
        for rid, n in enumerate((6, 20)):
            req = traffic.Request(rid=rid, arrival_s=0.0, decode_len=4,
                                  prompt=rng.integers(2, cfg.vocab_size, n).astype(np.int32))
            assert loop.kv.admit(rid, n)
            tok = loop._prefill_one(req)
            assert loop.kv.extend(rid, 1)
            rows.append(_Active(req=req, row=rid, admit_seq=rid, next_token=tok, pos=n,
                                generated=[tok]))
        logits = loop._decode(*loop._step_inputs(rows))
    finally:
        photonic.psram_matmul = launch
    n_proj = 7 * cfg.num_layers
    assert len(calls) == 3 * n_proj
    assert sorted({c[0].shape[0] for c in calls}) == [4, 8, 32]
    assert np.isfinite(logits).all()
    for qx, qw, sx, sw, adc_bits, out in calls:
        assert out.device.type == card.type
        assert torch.equal(out, psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits))
