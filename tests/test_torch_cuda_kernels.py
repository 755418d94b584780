"""The CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
source at first use); they carry the ``cuda`` marker and skip elsewhere.
Run them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

They import nothing of the JAX reference package. ``chip_smoke.py`` makes the
same comparisons at the main path's shapes and adds timings.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.psram import PsramConfig
from repro_torch.core.quantization import quantize_symmetric
from repro_torch.kernels import psram_matmul as pm
from repro_torch.kernels import stream_mttkrp as sm
from repro_torch.sparse import csf_for_mode, powerlaw_coo, stream_layout

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """Decided when the test runs, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n,adc_bits", [
    (128, 512, 128, 16), (77, 1043, 131, 16), (5, 7, 3, 16), (130, 64, 257, 8),
    (16, 2048, 8, 16), (300, 96, 1, 12),
])
def test_psram_matmul_kernel_bit_equal_to_plain(card, m, k, n, adc_bits):
    rng = np.random.default_rng(m + k + n)
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32), device=card)
    w = torch.tensor(rng.standard_normal((k, n)).astype(np.float32), device=card)
    qx, sx = quantize_symmetric(x, axis=-1)
    qw, sw = quantize_symmetric(w, axis=0)
    before = pm.psram_matmul.launches
    got = pm.psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits)
    torch.cuda.synchronize()
    assert pm.psram_matmul.launches == before + 1
    want = pm.psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits)
    assert torch.equal(got, want)
    # the same codes on the CPU give the same bits
    cpu = pm.psram_matmul_torch(qx.cpu(), qw.cpu(), sx.cpu(), sw.cpu(), adc_bits=adc_bits)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("shape,nnz,rank,rows,eb,mode,adc_bits", [
    ((40, 24, 18), 900, 6, 16, 4, 0, 16),      # ragged last block, empty rows, long head fiber
    ((40, 24, 18), 900, 6, 16, 4, 2, 0),       # ADC off
    ((50, 12, 9, 7), 20000, 40, 256, 32, 0, 16),   # 4 modes, rank over one 32-column tile
    ((50, 12, 9, 7), 20000, 40, 256, 32, 3, 16),
    ((300, 200, 100), 60000, 32, 256, 32, 1, 16),
])
def test_stream_kernel_bit_equal_to_stream_ordered_plain(card, shape, nnz, rank, rows,
                                                         eb, mode, adc_bits):
    """The kernel adds every segment and every output row in stream order,
    which is the order of the plain version's ``index_add_`` on the CPU: the
    two must agree bit for bit, pre-ADC chunk maxima included."""
    coo = powerlaw_coo(5, shape, nnz=nnz, rank=4, alpha=1.6, device=card)
    csf = csf_for_mode(coo, mode)
    gen = torch.Generator(device=card).manual_seed(1)
    fs = tuple(torch.randn((s, rank), generator=gen, device=card) for s in shape)
    ip, vp, lp, sp, n_seg = stream_layout(csf, PsramConfig(rows=rows).rows, eb)
    qs, ss = sm.quantize_stream_factors(fs, mode)
    args = (ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, shape[mode])
    before = sm.stream_mttkrp_fused.launches
    got, got_max = sm.stream_mttkrp_fused(*args, return_chunk_max=True)
    torch.cuda.synchronize()
    assert sm.stream_mttkrp_fused.launches == before + 1
    to_cpu = lambda v: tuple(t.cpu() for t in v) if isinstance(v, tuple) else (
        v.cpu() if isinstance(v, torch.Tensor) else v)
    want, want_max = sm.stream_mttkrp_fused_torch(*map(to_cpu, args), return_chunk_max=True)
    assert torch.equal(got_max.cpu(), want_max)
    assert torch.equal(got.cpu(), want)
    # deterministic: a second launch gives the same bits
    assert torch.equal(sm.stream_mttkrp_fused(*args), got)
