"""The SSM, hybrid and encoder-decoder families and M-RoPE on a card, held
against the same calls on the CPU.

The SSD scan, the depthwise conv, M-RoPE and cross attention are plain
PyTorch; the pSRAM projections go through kernel 2 (``psram_matmul``),
which builds on first use. These tests carry the ``cuda`` marker and skip
without a card; run them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda_models.py

They import nothing of the JAX reference package. Tolerances: the SSD scan
within 1e-5 of max |y| (f32, TF32 off inside the scan whatever the caller
set); the reduced models' logits within 1e-4 of max |logit| (f32 sums in
the card's order); kernel 2 bit-equal to its plain version.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import encdec, layers, ssm, transformer
from repro_torch.models.registry import get_config

pytestmark = pytest.mark.cuda


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


def _rel(got, want):
    return float((got.cpu() - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("tf32", [False, True], ids=["ieee", "caller_tf32"])
@pytest.mark.parametrize("s,chunk", [(200, 64), (256, 128), (37, 16)])
def test_ssd_chunked_card_equals_cpu(card, s, chunk, tf32):
    """Within 1e-5 of max |y| and of max |state|, also when the caller has
    switched TF32 on (``ssd_chunked`` pins it off)."""
    rng = np.random.default_rng(s)
    bsz, h, p, n = 2, 4, 16, 32
    arrays = [rng.standard_normal((bsz, s, h, p)), np.log1p(np.exp(rng.standard_normal((bsz, s, h)))),
              -np.exp(rng.standard_normal(h) * 0.3), rng.standard_normal((bsz, s, n)),
              rng.standard_normal((bsz, s, n))]
    cpu = [torch.tensor(a.astype(np.float32)) for a in arrays]
    y, st = ssm.ssd_chunked(*cpu, chunk)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yc, stc = ssm.ssd_chunked(*[t.to(card) for t in cpu], chunk)
    finally:
        torch.set_float32_matmul_precision(saved)
    assert yc.is_cuda
    assert _rel(yc, y) <= 1e-5 and _rel(stc, st) <= 1e-5


@pytest.mark.parametrize("arch", ["jamba_1p5_large", "mamba2_370m", "qwen2_vl_7b"])
def test_decoder_families_card_equals_cpu(card, arch):
    """Reduced (f32) forward, prefill and two decode steps on the card
    against the CPU on the same params."""
    cfg = get_config(arch).reduced()
    params = transformer.init(0, cfg, device="cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))
    pc, tc = _tree_to(params, card), toks.to(card)
    assert _rel(transformer.forward(pc, tc, cfg), transformer.forward(params, toks, cfg)) <= 1e-4
    lg, cache = transformer.prefill(params, toks[:, :10], cfg, cache_len=12)
    lgc, cachec = transformer.prefill(pc, tc[:, :10], cfg, cache_len=12)
    assert _rel(lgc, lg) <= 1e-4
    for t in (10, 11):
        lg, cache = transformer.decode_step(params, cache, toks[:, t], t, cfg)
        lgc, cachec = transformer.decode_step(pc, cachec, tc[:, t], t, cfg)
        assert _rel(lgc, lg) <= 1e-4


def test_encdec_card_equals_cpu(card):
    """Reduced seamless: encode, prefill and two decode steps."""
    cfg = get_config("seamless_m4t_large_v2").reduced()
    params = encdec.init(0, cfg, device="cpu")
    rng = np.random.default_rng(2)
    frames = torch.tensor(rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32))
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 10)))
    pc = _tree_to(params, card)
    assert _rel(encdec.encode(pc, frames.to(card), cfg), encdec.encode(params, frames, cfg)) <= 1e-4
    lg, cache = encdec.prefill(params, frames, toks[:, :8], cfg, cache_len=10)
    lgc, cachec = encdec.prefill(pc, frames.to(card), toks[:, :8].to(card), cfg, cache_len=10)
    assert _rel(lgc, lg) <= 1e-4
    for t in (8, 9):
        lg, cache = encdec.decode_step(params, cache, toks[:, t], t, cfg)
        lgc, cachec = encdec.decode_step(pc, cachec, toks[:, t].to(card), t, cfg)
        assert _rel(lgc, lg) <= 1e-4


def test_psram_mamba2_kernel2_equals_plain(card):
    """The pSRAM mamba2 blocks (stored int8 words): every ``in_proj`` and
    ``out_proj`` of a prefill and a decode step goes through kernel 2,
    bit-equal to its plain version on the operands it was given."""
    import repro_torch.core.photonic_layer as photonic
    from repro_torch.kernels.psram_matmul import psram_matmul_torch

    cfg = dataclasses.replace(get_config("mamba2_370m").reduced(), psram_projections=True,
                              psram_stored_int8=True)
    params = transformer.init(0, cfg, device=card)
    toks = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)),
                        device=card)
    launch, calls = photonic.psram_matmul, []

    def record(qx, qw, sx, sw, adc_bits=16, saturate=True):
        out = launch(qx, qw, sx, sw, adc_bits=adc_bits, saturate=saturate)
        calls.append((qx, qw, sx, sw, adc_bits, out))
        return out

    photonic.psram_matmul = record
    try:
        with torch.inference_mode():
            logits, cache = transformer.prefill(params, toks, cfg, cache_len=13)
            step, _ = transformer.decode_step(params, cache, logits.argmax(-1), 12, cfg)
    finally:
        photonic.psram_matmul = launch
    # a prefill: in_proj, in_proj on the conv tail, out_proj a layer; a step: 2
    assert len(calls) == 5 * cfg.num_layers
    assert bool(torch.isfinite(step).all())
    for qx, qw, sx, sw, adc_bits, out in calls:
        assert out.is_cuda
        assert torch.equal(out, psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits))


def test_mrope_card_equals_cpu(card):
    """``apply_rope`` with three distinct position streams. The angles are
    bit-equal (the inverse frequencies are the CPU's on both devices); only
    cos/sin may differ (the card's libm against the CPU's). In f32 the output
    lies within ``2^-20 * (|x_rot| + |rot_half(x_rot)|)``; in bf16 the cos/sin
    tables within one bf16 ulp, which moves the output through its bf16
    products and sum by at most ``5 * 2^-8`` of the same."""
    cfg = get_config("qwen2_vl_7b")
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((2, 64, 4, cfg.head_dim)).astype(np.float32))
    pos = torch.stack([torch.arange(64), torch.arange(64) // 8, torch.arange(64) % 8])
    pos = pos[:, None].expand(3, 2, 64).to(torch.int32)
    assert torch.equal(layers._rope_angles(pos.to(card), cfg.head_dim, cfg).cpu(),
                       layers._rope_angles(pos, cfg.head_dim, cfg))
    terms = x.abs() + layers._rot_half(x).abs()
    for dtype, bound in ((torch.float32, 2.0 ** -20), (torch.bfloat16, 5 * 2.0 ** -8)):
        xd = x.to(dtype)
        want = layers.apply_rope(xd, pos, cfg).float()
        got = layers.apply_rope(xd.to(card), pos.to(card), cfg).float().cpu()
        assert bool(((got - want).abs() <= bound * terms).all()), dtype
