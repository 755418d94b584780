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

from repro_torch.core.photonic_layer import program_weights, psram_linear
from repro_torch.core.psram import PsramConfig
from repro_torch.core.quantization import quantize_symmetric
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mttkrp as dm
from repro_torch.kernels import ordered_fold as of
from repro_torch.kernels import psram_matmul as pm
from repro_torch.kernels import segment_sum as ss
from repro_torch.kernels import stream_mttkrp as sm
from repro_torch.sparse import COO, csf_for_mode, powerlaw_coo, stream_layout

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


DENSE_SHAPES = [
    (256, 24, 128, 32),   # two row tiles, 16-byte rows
    (96, 5, 40, 7),       # bi = I = 96, bk = K = 40, rank under one column tile
    (32, 3, 11, 40),      # J*K = 33: element loads; rank over one column tile
    (128, 7, 36, 16),     # J*K = 252: 16-byte f32 rows, element-wise int8 rows
    (384, 37, 12, 32),    # I not a multiple of the ring's 256 rows; J*K = 444 splits unevenly
    (512, 13, 7, 33),     # J*K = 91 (not a multiple of 4): element loads; K < 32 stages
    (128, 3, 100, 32),    # J*K = 300: the ring's stages straddle j, 10 stages split unevenly
]


def _dense_operands(card, i, j, k, r, seed):
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(rng.standard_normal((i, j * k)).astype(np.float32), device=card)
    b = torch.tensor(rng.uniform(size=(j, r)).astype(np.float32), device=card)
    c = torch.tensor(rng.standard_normal((k, r)).astype(np.float32), device=card)
    return x0, b, c


@pytest.mark.parametrize("i,j,k,r", DENSE_SHAPES)
def test_dense_mttkrp_kernel_vs_plain(card, i, j, k, r):
    """Exact kernel: f32 FMAs reassociated against the plain version (the
    reference's own tolerance, rtol 2e-4 and 2e-4 of the largest entry);
    deterministic from launch to launch."""
    x0, b, c = _dense_operands(card, i, j, k, r, i + j + k + r)
    before = dm.mttkrp_fused.launches
    got = dm.mttkrp_fused(x0, b, c)
    torch.cuda.synchronize()
    assert dm.mttkrp_fused.launches == before + 1
    want = dm.mttkrp_fused_torch(x0, b, c)
    atol = 2e-4 * float(want.abs().max())
    assert torch.allclose(got, want, rtol=2e-4, atol=atol)
    assert torch.allclose(got.cpu(), dm.mttkrp_fused_torch(x0.cpu(), b.cpu(), c.cpu()),
                          rtol=2e-4, atol=atol)
    assert torch.equal(dm.mttkrp_fused(x0, b, c), got)


@pytest.mark.parametrize("i,j,k,r", DENSE_SHAPES)
@pytest.mark.parametrize("adc_bits", [16, 8])
def test_dense_psram_kernel_vs_plain(card, i, j, k, r, adc_bits):
    """int8 kernel: the ADC of each bi-row tile over its own full scale, so
    within two codes of that scale plus rtol 2e-4 of the plain version."""
    q = dm.quantize_mttkrp_operands(*_dense_operands(card, i, j, k, r, 7 * i + r))
    before = dm.mttkrp_psram_fused.launches
    got = dm.mttkrp_psram_fused(*q, adc_bits=adc_bits)
    torch.cuda.synchronize()
    assert dm.mttkrp_psram_fused.launches == before + 1
    want = dm.mttkrp_psram_torch(*q, adc_bits=adc_bits)
    bi = min(128, i)
    fs = want.abs().reshape(i // bi, -1).amax(dim=1).clamp_min(1e-30)
    lsb = (2.0 * fs / 2 ** adc_bits).repeat_interleave(bi)[:, None]
    assert ((got - want).abs() <= 2 * lsb + 2e-4 * want.abs()).all()
    assert torch.equal(dm.mttkrp_psram_fused(*q, adc_bits=adc_bits), got)


@pytest.mark.parametrize("b,bn,r,n_seg,sorted_ids", [
    (64, 256, 32, 40, True), (9, 100, 40, 17, False), (3, 5, 3, 9, False),
    (4, 600, 8, 500, False),    # a 64 KB shared-memory tile
])
def test_segment_sum_kernel_bit_equal_to_cpu_plain(card, b, bn, r, n_seg, sorted_ids):
    """The kernel adds every row in order, as the plain version's index_add_
    does on the CPU: bit-equal."""
    rng = np.random.default_rng(b * bn)
    data = torch.tensor(rng.standard_normal((b, bn, r)).astype(np.float32), device=card)
    ids = rng.integers(0, n_seg, size=(b, bn)).astype(np.int32)
    if sorted_ids:
        ids.sort(axis=1)
    ids = torch.tensor(ids, device=card)
    before = ss.blocked_segment_sum.launches
    got = ss.blocked_segment_sum(data, ids, n_seg)
    torch.cuda.synchronize()
    assert ss.blocked_segment_sum.launches == before + 1
    assert torch.equal(got.cpu(), ss.blocked_segment_sum_torch(data.cpu(), ids.cpu(), n_seg))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,softcap,tile", [
    (2, 4, 4, 256, 256, 64, True, 0.0, 128),
    (2, 4, 2, 256, 256, 64, True, 0.0, 128),     # GQA
    (1, 8, 1, 128, 128, 32, True, 0.0, 128),     # MQA
    (2, 4, 4, 256, 256, 64, False, 0.0, 128),
    (2, 4, 2, 128, 128, 64, True, 50.0, 128),    # softcap
    (1, 4, 2, 100, 100, 128, True, 0.0, 128),    # ragged: one partial q tile and kv tile
    (1, 2, 2, 64, 64, 16, False, 0.0, 128),
    # the bf16 kernel's 128-row tiles: S under one (64, 100) and across
    # them (320 = 2.5 tiles), every head dim, GQA rep 4, softcap 50
    (1, 4, 1, 64, 64, 16, True, 0.0, 128),
    (1, 8, 2, 320, 320, 32, True, 0.0, 64),
    (2, 8, 2, 100, 100, 64, True, 50.0, 128),
    (1, 8, 2, 320, 320, 128, True, 50.0, 64),
    (1, 8, 2, 320, 320, 128, False, 0.0, 64),
    # causal with Sq != Skv, top-left aligned
    (1, 2, 2, 64, 128, 16, True, 0.0, 64),
    (1, 2, 2, 128, 64, 16, True, 0.0, 64),
    (1, 8, 2, 128, 384, 128, True, 0.0, 128),
    (1, 8, 2, 384, 128, 128, True, 0.0, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_vs_plain(card, b, h, hkv, sq, skv, d, causal, softcap, tile, dtype):
    """f32: within 1e-5 of max |out| (online vs exact softmax, sums in another
    order). bf16: every element within one bf16 ulp of the plain version
    (which rounds its f32 result once) plus 2^-16 of sum_j p_j |v_j|, the
    envelope of the reassociated sums and of the two-term bf16 split of P.
    ``tile`` is the reference's bq = bkv, which only validates the shapes."""
    gen = torch.Generator(device=card).manual_seed(b * h + sq + skv + d)
    q = torch.randn((b, h, sq, d), generator=gen, device=card).to(dtype)
    k = torch.randn((b, hkv, skv, d), generator=gen, device=card).to(dtype)
    v = torch.randn((b, hkv, skv, d), generator=gen, device=card).to(dtype)
    kw = dict(causal=causal, softcap=softcap, bq=tile, bkv=tile)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_torch(q, k, v, **kw)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * float(want.abs().max())
    else:
        mag = fa.flash_attention_torch(q, k, v.abs(), **kw).float()
        assert bool((diff <= _bf16_ulp(want) + 2.0 ** -16 * mag).all())
    assert torch.equal(fa.flash_attention(q, k, v, **kw), got)


def test_flash_kernel_refuses_what_the_reference_refuses(card):
    """Shapes the reference refuses raise; so does a head dim above the
    largest kernel (128), the one thing the kernel does not take."""
    q = torch.zeros((1, 2, 192, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of bq"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dims up to 128"):
        z = torch.zeros((1, 2, 64, 160), device=card, dtype=torch.bfloat16)
        fa.flash_attention(z, z, z)


def test_psram_linear_bf16_activation_launches_the_kernel(card):
    """A 3-D bf16 activation through psram_linear: one kernel launch,
    bit-equal to the plain version on the same codes and scales."""
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.standard_normal((2, 37, 96)).astype(np.float32),
                     device=card).to(torch.bfloat16)
    w = torch.tensor(rng.standard_normal((96, 72)).astype(np.float32) / 10, device=card)
    prog = program_weights(w)
    before = pm.psram_matmul.launches
    got = psram_linear(x, prog)
    torch.cuda.synchronize()
    assert pm.psram_matmul.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 37, 72)
    qx, sx = quantize_symmetric(x.reshape(-1, 96), axis=-1)
    want = pm.psram_matmul_torch(qx, prog["q"], sx.float(), prog["scale"])
    assert torch.equal(got.reshape(-1, 72), want)
    with pytest.raises(ValueError, match="saturate"):
        psram_linear(x, prog, saturate=False)


# ------------------------------------------------ kernel 2's decode route

DECODE_SHAPES = [
    (8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336), (8, 14336, 4096),   # granite-8b decode
    (1, 4096, 1024), (16, 4096, 4096), (9, 4096, 1024),                     # one row, two n8 tiles
    (3, 1043, 131), (5, 33, 7), (16, 2048, 8), (13, 100, 1000),             # ragged K and N
]


def _codes(card, m, k, n, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=card)
    w = torch.randn((k, n), generator=gen, device=card)
    qx, sx = quantize_symmetric(x, axis=-1)
    qw, sw = quantize_symmetric(w, axis=0)
    return qx, qw, sx, sw


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("m,k,n", DECODE_SHAPES)
def test_psram_matmul_decode_route_bit_equal_and_counted(card, m, k, n):
    """M <= 16 takes the decode kernel: bit-equal to the plain version (and
    to the tile route), the same bits on a second launch, counted as the
    ``decode`` route; every cluster size gives the same bits."""
    qx, qw, sx, sw = _codes(card, m, k, n, m + k + n)
    before, routes = pm.psram_matmul.launches, dict(pm.psram_matmul.routes)
    got = pm.psram_matmul(qx, qw, sx, sw)
    torch.cuda.synchronize()
    assert pm.psram_matmul.launches == before + 1
    assert pm.psram_matmul.routes["decode"] == routes["decode"] + 1
    assert pm.psram_matmul.routes["tile"] == routes["tile"]
    want = pm.psram_matmul_torch(qx, qw, sx, sw)
    assert torch.equal(got, want)
    assert torch.equal(pm.psram_matmul(qx, qw, sx, sw), got)
    assert torch.equal(pm._launch(qx, qw, sx, sw, route="tile"), got)
    assert pm._decode_cluster(k, n, _sms()) in (1, 2, 4, 8)
    for cluster in (1, 2, 4, 8):
        assert torch.equal(pm._launch(qx, qw, sx, sw, route="decode", cluster=cluster), got)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (4, 1043, 131)])
def test_psram_matmul_decode_route_unaligned_operands(card, m, k, n):
    """Operands that start one byte into their storage (views of a larger
    buffer) take the guarded loads and give the same bits."""
    qx, qw, sx, sw = _codes(card, m, k, n, 3 * k + n)
    bx = torch.empty(qx.numel() + 1, dtype=torch.int8, device=card)
    bw = torch.empty(qw.numel() + 1, dtype=torch.int8, device=card)
    ux = bx[1:].view(m, k).copy_(qx)
    uw = bw[1:].view(k, n).copy_(qw)
    assert ux.data_ptr() % 4 and uw.data_ptr() % 4
    got = pm._launch(ux, uw, sx, sw, route="decode")
    assert torch.equal(got, pm.psram_matmul_torch(qx, qw, sx, sw))


# --------------------------------------------------------- the ordered fold


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_exact_sparse_mttkrp_on_the_card_is_ordered(card, mode):
    """``mttkrp_sparse`` (unsorted COO) and ``stream_mttkrp`` (steps that
    split the head fiber) on the card: BIT-EQUAL to the same functions on
    the CPU (stream-ordered index_add_) and the same bits on a second run;
    every step launches the ordered fold."""
    from repro_torch.core.mttkrp import mttkrp_sparse
    from repro_torch.sparse.stream import stream_mttkrp

    coo = powerlaw_coo(5, (300, 200, 100), nnz=60000, rank=4, alpha=1.6, device=card)
    gen = torch.Generator(device=card).manual_seed(mode)
    fs = tuple(torch.randn((s, 32), generator=gen, device=card) for s in coo.shape)
    perm = torch.randperm(coo.nnz, generator=gen, device=card)
    idx, vals = coo.indices[perm], coo.values[perm]
    before = of.ordered_fold.launches
    got = mttkrp_sparse(idx, vals, fs, mode, coo.shape[mode])
    torch.cuda.synchronize()
    assert of.ordered_fold.launches == before + 1
    cpu = lambda t: t.cpu()
    want = mttkrp_sparse(cpu(idx), cpu(vals), tuple(map(cpu, fs)), mode, coo.shape[mode])
    assert torch.equal(got.cpu(), want)
    assert torch.equal(mttkrp_sparse(idx, vals, fs, mode, coo.shape[mode]), got)
    csf = csf_for_mode(coo, mode)
    cfg = PsramConfig(rows=64)
    got_s = stream_mttkrp(csf, fs, cfg, exec_blocks=3)
    csf_cpu = csf_for_mode(COO(indices=cpu(coo.indices), values=cpu(coo.values),
                               shape=coo.shape), mode)
    want_s = stream_mttkrp(csf_cpu, tuple(map(cpu, fs)), cfg, exec_blocks=3)
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(stream_mttkrp(csf, fs, cfg, exec_blocks=3), got_s)


@pytest.mark.parametrize("r,offset", [(32, 0), (6, 0), (40, 1), (3000, 0)])
def test_ordered_fold_kernel_bit_equal_to_cpu(card, r, offset):
    """The kernel on its own: 16-byte and 4-byte copies (R % 4, a d that
    starts one float into its storage), a run longer than the ring, one-row
    stages (R over 2048), empty rows; the fold starts from out's values."""
    rng = np.random.default_rng(r + offset)
    n, rows = 5000 if r < 1000 else 300, 23
    ids = np.sort(rng.integers(0, rows, size=n))
    ids[: n // 2] = 4                                  # a long run
    ids = np.sort(ids)
    d = torch.tensor(rng.standard_normal((n * r + offset,)).astype(np.float32), device=card)
    d = d[offset:].view(n, r)
    start = torch.tensor(rng.standard_normal((rows, r)).astype(np.float32), device=card)
    tid = torch.tensor(ids, device=card)
    got = of.ordered_fold(start.clone(), d, tid)
    want = of.ordered_fold_torch(start.cpu(), d.cpu(), tid.cpu())
    assert torch.equal(got.cpu(), want)


# ----------------------------------------------- flash: fp16 and padded D


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.float16, 80),
                                     (torch.float32, 48), (torch.float32, 96),
                                     (torch.bfloat16, 80)])
def test_flash_kernel_fp16_and_padded_head_dims(card, dtype, d):
    """fp16 runs the f32 kernel on staged copies and rounds once; a head
    dim outside the kernel's runs zero-padded. One launch each, within the
    envelope of the dtype it ran in: f32 1e-5 of max |out| (plus one fp16 ulp
    where the result is rounded to fp16), bf16 one bf16 ulp + 2^-16 of
    sum_j p_j |v_j|."""
    gen = torch.Generator(device=card).manual_seed(d)
    q = torch.randn((1, 8, 256, d), generator=gen, device=card).to(dtype)
    k = torch.randn((1, 2, 256, d), generator=gen, device=card).to(dtype)
    v = torch.randn((1, 2, 256, d), generator=gen, device=card).to(dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_torch(q, k, v, causal=True)
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    if dtype == torch.bfloat16:
        mag = fa.flash_attention_torch(q, k, v.abs(), causal=True).float()
        assert bool((diff <= _bf16_ulp(want) + 2.0 ** -16 * mag).all())
    elif dtype == torch.float16:
        ulp = torch.ldexp(torch.ones_like(diff), torch.frexp(want.float().abs())[1] - 11)
        assert bool((diff <= ulp + 1e-5 * top).all())
    else:
        assert float(diff.max()) <= 1e-5 * top
    assert torch.equal(fa.flash_attention(q, k, v, causal=True), got)


# -------------------------------------------------------- the TF32 pin


def test_exact_backend_ignores_the_callers_tf32_setting(card):
    """Under ``set_float32_matmul_precision("high")`` the exact backend's
    dense MTTKRP and matmul give the same bits as under "highest", and the
    caller's setting is back after the call."""
    from repro_torch import backends

    gen = torch.Generator(device=card).manual_seed(4)
    x = torch.randn((64, 48, 40), generator=gen, device=card)
    fs = tuple(torch.randn((s, 16), generator=gen, device=card) for s in x.shape)
    a = torch.randn((256, 512), generator=gen, device=card)
    w = torch.randn((512, 384), generator=gen, device=card)
    exact = backends.get("exact")
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = [exact.mttkrp(x, fs, m) for m in range(3)] + [exact.matmul(a, w)]
        torch.set_float32_matmul_precision("high")
        got = [exact.mttkrp(x, fs, m) for m in range(3)] + [exact.matmul(a, w)]
        assert torch.backends.cuda.matmul.allow_tf32
        assert all(torch.equal(g, h) for g, h in zip(got, want))
    finally:
        torch.set_float32_matmul_precision(saved)
