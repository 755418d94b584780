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

torch = pytest.importorskip("torch")

from repro_torch.core.photonic_layer import program_weights, psram_linear
from repro_torch.core.psram import PsramConfig
from repro_torch.core.quantization import quantize_symmetric, symmetric_scale
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


@pytest.mark.parametrize("route", ["decode", "tile", "wgmma"])
@pytest.mark.parametrize("m,k,n,adc_bits", [
    (8, 1024, 256, 16), (16, 4096, 96, 12), (64, 2048, 128, 16), (300, 1024, 48, 24),
])
def test_psram_matmul_int32_split_k_bit_equal_to_fused(card, route, m, k, n, adc_bits):
    """Each route with its epilogue compiled out over 4 K slices, the int32
    sums added, then the epilogue launch: the fused kernel's bits, each
    slice's sums the plain integer product."""
    if route == "decode" and m > pm.M_DECODE:
        pytest.skip("the decode route takes up to 16 rows")
    rng = np.random.default_rng(m * 7 + k + n)
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32), device=card)
    w = torch.tensor(rng.standard_normal((k, n)).astype(np.float32), device=card)
    qx, sx = quantize_symmetric(x, axis=-1)
    qw, sw = quantize_symmetric(w, axis=0)
    ks = k // 4
    before = (dict(pm.psram_matmul_int32.routes), pm.psram_adc_epilogue.launches)
    acc = None
    for i in range(4):
        a, b = qx[:, i * ks:(i + 1) * ks].contiguous(), qw[i * ks:(i + 1) * ks].contiguous()
        part = pm.psram_matmul_int32(a, b, route=route)
        assert part.dtype == torch.int32
        assert torch.equal(part.cpu(), pm.psram_matmul_int32(a.cpu(), b.cpu()))
        acc = part if acc is None else acc + part
    got = pm.psram_adc_epilogue(acc, sx, sw, k, adc_bits=adc_bits)
    torch.cuda.synchronize()
    assert pm.psram_matmul_int32.routes[route] == before[0][route] + 4
    assert pm.psram_adc_epilogue.launches == before[1] + 1
    assert torch.equal(got, pm.psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits))
    cpu = pm.psram_adc_epilogue(acc.cpu(), sx.cpu(), sw.cpu(), k, adc_bits=adc_bits)
    assert torch.equal(got.cpu(), cpu)


def _rows_operands(m, k, n, dtype, card, offset=0, seed=0):
    """Rows ``x`` (M, K) in ``dtype`` with scales over a wider row's maximum,
    int8 ``qw`` (K, N); ``offset`` elements in front of each in its buffer
    (an unaligned base)."""
    rng = np.random.default_rng(seed + m * 31 + k + n)
    xs = rng.standard_normal((m, k)).astype(np.float32)
    amax = np.abs(xs).max(axis=1, keepdims=True) * rng.uniform(1.0, 2.0, (m, 1))
    x = torch.empty(m * k + offset, dtype=dtype, device=card)[offset:].view(m, k)
    x.copy_(torch.tensor(xs))
    sx = symmetric_scale(torch.tensor(amax, dtype=torch.float32).to(dtype).to(card))
    qw = torch.empty(k * n + offset, dtype=torch.int8, device=card)[offset:].view(k, n)
    qw.copy_(torch.tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8))
    return x, sx, qw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k,n,offset", [(1024, 4096, 0), (3584, 4096, 0), (1043, 200, 0),
                                        (1024, 136, 1)])
def test_psram_matmul_int32_rows_bit_equal_to_plain(card, m, k, n, offset, dtype):
    """The slice that quantizes its own rows: the composition it replaces
    (the quantization ops + the int32 decode route) bit for bit, and the
    CPU's plain version; at every layout; one launch counted a call."""
    x, sx, qw = _rows_operands(m, k, n, dtype, card, offset)
    before = pm.psram_matmul_int32_rows.launches
    got = pm.psram_matmul_int32_rows(x, sx, qw)
    torch.cuda.synchronize()
    assert pm.psram_matmul_int32_rows.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, pm.psram_matmul_int32_rows_torch(x, sx, qw))
    assert torch.equal(got.cpu(), pm.psram_matmul_int32_rows(x.cpu(), sx.cpu(), qw.cpu()))
    for nb in (1, 2):
        for warps in (4, 8):
            for cluster in (1, 2, 4, 8):
                lay = pm.rows_layout(nb, warps, cluster)
                assert torch.equal(pm.psram_matmul_int32_rows(x, sx, qw, layout=lay), got), lay


def test_rows_division_probe_exhaustive(card):
    """The bf16 rows' quotient from the scale's reciprocal gives
    ``__fdiv_rn``'s code for every bf16 value at every bf16 scale
    ``symmetric_scale`` can give."""
    count, first, checked = pm._rows_division_probe()
    assert checked > 10 ** 9
    assert count == 0, f"{count} pairs differ, the first (s << 16 | v) {first:#x}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n,offset", [(8, 4096, 0), (2048, 4096, 0), (5, 1030, 0),
                                        (64, 4096, 1)])
def test_psram_adc_epilogue_out_dtypes(card, m, n, offset, dtype):
    """The epilogue launch in f32 and bf16, N % 4 = 0 and not, an unaligned
    base: the plain arithmetic on the card and on the CPU, bf16 the f32
    result rounded once; one launch counted a call."""
    rng = np.random.default_rng(m + n + offset)
    k = 1024
    acc = torch.empty(m * n + offset, dtype=torch.int32, device=card)[offset:].view(m, n)
    acc.copy_(torch.tensor(rng.integers(-(127 ** 2) * k, 127 ** 2 * k, (m, n)), dtype=torch.int32))
    sx = torch.tensor(rng.uniform(1e-3, 1.0, (m, 1)), dtype=torch.float32, device=card)
    sw = torch.tensor(rng.uniform(1e-3, 1.0, (1, n)), dtype=torch.float32, device=card)
    before = pm.psram_adc_epilogue.launches
    got = pm.psram_adc_epilogue(acc, sx, sw, k, out_dtype=dtype)
    torch.cuda.synchronize()
    assert pm.psram_adc_epilogue.launches == before + 1
    assert got.dtype == dtype
    want = pm.psram_adc_epilogue(acc.cpu(), sx.cpu(), sw.cpu(), k, out_dtype=dtype)
    assert torch.equal(got.cpu(), want)
    if dtype == torch.bfloat16:
        assert torch.equal(got, pm.psram_adc_epilogue(acc, sx, sw, k).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (16, 1024 * 4 + 12, 96), (1, 6144, 256)])
def test_rows_split_k_bit_equal_to_fused(card, m, k, n, dtype):
    """Four K slices through the rows slice, their sums added, the epilogue
    on the whole K: the fused kernel's bits on the codes of the whole K."""
    x, sx, qw = _rows_operands(m, k, n, dtype, card, seed=3)
    sx = symmetric_scale(x.abs().amax(dim=-1, keepdim=True))
    rng = np.random.default_rng(k)
    sw = torch.tensor(rng.uniform(1e-3, 1.0, (1, n)), dtype=torch.float32, device=card)
    ks = k // 4
    acc = sum(pm.psram_matmul_int32_rows(x[:, i * ks:(i + 1) * ks].contiguous(), sx,
                                         qw[i * ks:(i + 1) * ks].contiguous())
              for i in range(4))
    got = pm.psram_adc_epilogue(acc.to(torch.int32), sx.float(), sw, k)
    qx = torch.round(x / sx).clamp(-127, 127).to(torch.int8)
    assert torch.equal(got, pm.psram_matmul(qx, qw.contiguous(), sx.float(), sw))


@pytest.mark.parametrize("shape,nnz,rank,rows,eb,mode,adc_bits,alpha,route", [
    ((40, 24, 18), 900, 6, 16, 4, 0, 16, 1.6, "three_pass"),  # ragged last block, empty rows,
                                                              # long head fiber
    ((40, 24, 18), 900, 6, 16, 4, 2, 0, 1.6, "three_pass"),   # ADC off
    ((50, 12, 9, 7), 20000, 40, 256, 32, 0, 16, 1.6, "three_pass"),  # 4 modes, R = 40: over a
    ((50, 12, 9, 7), 20000, 40, 256, 32, 3, 16, 1.6, "three_pass"),  # 32-column tile, rows not
                                                                      # a multiple of 16 bytes
    ((300, 200, 100), 60000, 32, 256, 32, 1, 16, 1.6, "chunk"),
    ((300, 200, 100), 60000, 16, 256, 32, 0, 16, 1.6, "chunk"),      # 8 blocks a warp
    ((300, 200, 100), 60000, 64, 256, 32, 2, 16, 1.6, "chunk"),      # 2 blocks a warp
    ((300, 200, 100), 60000, 128, 16, 7, 0, 0, 1.6, "chunk"),        # 1 block a warp, 7 warps
    ((300, 200, 100), 60000, 16, 16, 5, 0, 16, 1.6, "chunk"),        # E = 5 on a warp of 8
    ((300, 200), 30000, 32, 64, 16, 1, 16, 1.6, "chunk"),            # 2 modes: one factor
    ((40, 24, 18), 900, 32, 16, 4, 0, 16, 1.6, "chunk"),             # rows < a warp's batch
    ((300, 200, 100), 60000, 32, 18, 8, 2, 16, 1.6, "chunk"),        # rows % 8 != 0
    ((20, 9, 8, 7, 6), 20000, 32, 256, 32, 0, 16, 1.6, "chunk"),     # 4 non-target factors
    ((12, 9, 8, 7, 6, 5), 20000, 32, 64, 8, 2, 16, 1.6, "chunk"),    # 5: the f32 chain
    ((20000, 40, 30), 20000, 64, 64, 64, 0, 16, 0.0, "three_pass"),  # short fibers: the
                                                              # chunk's partials overflow
    ((40, 3000, 200), 400000, 32, 16, 32, 0, 16, 1.6, "chunk"),      # a 10,185-segment row
    ((40, 3000, 200), 400000, 6, 16, 32, 0, 16, 1.6, "three_pass"),  # ... its ring in 4-byte
                                                                      # copies (R % 4 != 0)
])
def test_stream_kernel_bit_equal_to_stream_ordered_plain(card, shape, nnz, rank, rows, eb,
                                                         mode, adc_bits, alpha, route):
    """The kernel adds every segment and every output row in stream order,
    which is the order of the plain version's ``index_add_`` on the CPU: the
    two must agree bit for bit, pre-ADC chunk maxima included, on the route
    the layout takes and on every other route that can take it (a route
    that cannot raises), and a second launch gives the same bits."""
    coo = powerlaw_coo(5, shape, nnz=nnz, rank=4, alpha=alpha, device=card)
    csf = csf_for_mode(coo, mode)
    gen = torch.Generator(device=card).manual_seed(1)
    fs = tuple(torch.randn((s, rank), generator=gen, device=card) for s in shape)
    ip, vp, lp, sp, n_seg = stream_layout(csf, PsramConfig(rows=rows).rows, eb)
    qs, ss = sm.quantize_stream_factors(fs, mode)
    args = (ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, shape[mode])
    plan = sm.SegmentPlan.build(lp, sp, n_seg, shape[mode])
    before, routes = sm.stream_mttkrp_fused.launches, dict(sm.stream_mttkrp_fused.routes)
    got, got_max = sm.stream_mttkrp_fused(*args, plan=plan, return_chunk_max=True)
    torch.cuda.synchronize()
    assert sm.stream_mttkrp_fused.launches == before + 1
    assert sm.stream_mttkrp_fused.routes == {**routes, route: routes[route] + 1}
    to_cpu = lambda v: tuple(t.cpu() for t in v) if isinstance(v, tuple) else (
        v.cpu() if isinstance(v, torch.Tensor) else v)
    want, want_max = sm.stream_mttkrp_fused_torch(*map(to_cpu, args), return_chunk_max=True)
    assert torch.equal(got_max.cpu(), want_max)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(sm.stream_mttkrp_fused(*args, plan=plan), got)
    for other in sm.ROUTES:
        if other == "chunk" and route != "chunk":
            with pytest.raises(ValueError, match="chunk route needs"):
                sm._launch(*args, plan=plan, route=other)
            continue
        again, again_max = sm._launch(*args, plan=plan, return_chunk_max=True, route=other)
        assert torch.equal(again, got) and torch.equal(again_max, got_max)


def test_stream_kernel_chunk_route_unaligned_codes(card):
    """Codes that start 4 bytes into their storage: cp.async cannot copy
    their rows 16 bytes at a time, so the layout takes the three_pass route
    and a forced chunk launch raises."""
    shape, rank, mode = (300, 200, 100), 32, 0
    coo = powerlaw_coo(5, shape, nnz=60000, rank=4, alpha=1.6, device=card)
    csf = csf_for_mode(coo, mode)
    gen = torch.Generator(device=card).manual_seed(2)
    fs = tuple(torch.randn((s, rank), generator=gen, device=card) for s in shape)
    ip, vp, lp, sp, n_seg = stream_layout(csf, 256, 32)
    qs, ss = sm.quantize_stream_factors(fs, mode)
    shifted = []
    for q in qs:
        buf = torch.empty(q.numel() + 4, dtype=torch.int8, device=card)
        shifted.append(buf[4:].view(q.shape).copy_(q))
    args = (ip, vp, lp, sp, tuple(shifted), ss, mode, n_seg, 16, shape[mode])
    routes = dict(sm.stream_mttkrp_fused.routes)
    got = sm.stream_mttkrp_fused(*args)
    assert sm.stream_mttkrp_fused.routes["three_pass"] == routes["three_pass"] + 1
    assert torch.equal(got, sm.stream_mttkrp_fused(ip, vp, lp, sp, qs, ss, mode, n_seg, 16,
                                                   shape[mode]))
    with pytest.raises(ValueError, match="chunk route needs"):
        sm._launch(*args, route="chunk")


def test_stream_kernel_constants_are_the_librarys(card):
    """The route rule reads a chunk-route CTA's size from the library, laid
    out as the CPU route tests assume it (``chunk_smem`` of
    ``test_torch_stream_mttkrp.py``): 8 warps x (3 slots of 32 nonzeros'
    factor rows and scales, 5 slots of their coordinates, values, segment
    ids and scales; 2 and 3 at rank 128), 16 warp maxima, the partials."""
    for nmodes, rank, segs in ((3, 32, 40), (2, 16, 1), (8, 128, 300), (5, 64, 2645)):
        k = nmodes - 1
        rows_slots, meta_slots = (2, 3) if rank == 128 else (3, 5)
        ring = 8 * (rows_slots * (32 * k * rank + 32 * k * 4)
                    + meta_slots * (32 * nmodes * 4 + 3 * 32 * 4)) + 16 * 4
        assert sm._chunk_smem(rank, nmodes, segs) == ring + 4 * segs * rank


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


# ------------------------------------- kernel 4 reading the tensor in place

# (I, J, K): every mode's unfolding TMA can read; Rw and the KR's K within
# the reference's bi/bk preconditions. I = 384 and Rw = 64, 36, 20, 8 are
# not multiples of the ring's 256 rows; mode 1's B = K is 36 and 48 in the
# last two (B % 32 != 0: its stages stop at each a).
STRIDED_SHAPES = [(256, 12, 64), (384, 20, 36), (100, 8, 48)]


def _perm(mode):
    return [mode] + [d for d in range(3) if d != mode]


def _strided_case(card, shape, mode, seed, r=32):
    """The permuted view of a seeded tensor with two rows of its mode-m
    unfolding made hard: row 0 all zero (scale 1e-12/127) and row 1 of
    half-integer values up to 127 (scale 1, every quotient a tie)."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32), device=card)
    idx = (slice(None),) * mode
    x[idx + (0,)] = 0.0
    halves = rng.integers(-127, 127, size=x[idx + (1,)].shape) + 0.5
    x[idx + (1,)] = torch.tensor(halves.astype(np.float32), device=card)
    first = [0, 0, 0]
    first[mode] = 1
    x[tuple(first)] = 127.0                      # the row's max: its scale is 1
    others = [d for d in range(3) if d != mode]
    b = torch.tensor(rng.uniform(size=(shape[others[0]], r)).astype(np.float32), device=card)
    c = torch.tensor(rng.standard_normal((shape[others[1]], r)).astype(np.float32), device=card)
    return x.permute(_perm(mode)), b, c


@pytest.mark.parametrize("shape", STRIDED_SHAPES)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_drive_codes_and_scales_equal_quantize_symmetric(card, shape, mode):
    """The f32 front end's codes (its converter's device function, written
    out) and the row-max pass's scales are quantize_symmetric's on the
    unfolding, bit for bit: ties, an all-zero row, every mode's layout."""
    view, _, _ = _strided_case(card, shape, mode, 3 * mode + shape[0])
    q, s = quantize_symmetric(view.reshape(shape[mode], -1), axis=-1)
    sx = dm.drive_scales(view)
    assert torch.equal(sx, s)
    assert float(sx[0]) == pytest.approx(1e-12 / 127, rel=1e-6) and float(sx[1]) == 1.0
    assert torch.equal(dm.drive_codes(view, sx), q)


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_drive_codes_round_the_ieee_quotient(card, layout):
    """The converter's quotient (reciprocal + two fma corrections, no
    division) rounds as torch's IEEE ``x / s`` does: 16.7 M values against
    row scales over 26 decades, a third of them within two ulps of a
    half-integer quotient, any sign."""
    rows, cols = 2048, 8192
    gen = torch.Generator(device=card).manual_seed(17)
    s = (10.0 ** (torch.rand((rows, 1), generator=gen, device=card, dtype=torch.float64)
                  * 26 - 13)).float()
    t = (torch.rand((rows, cols), generator=gen, device=card) * 2 - 1) * 127
    ties = torch.randint(-127, 127, (rows, cols), generator=gen, device=card).float() + 0.5
    pick = torch.rand((rows, cols), generator=gen, device=card) < 1 / 3
    x = torch.where(pick, ties, t) * s
    nudge = torch.randint(-2, 3, (rows, cols), generator=gen, device=card)
    bits = x.view(torch.int32) + torch.where(pick, nudge, torch.zeros_like(nudge)).int()
    x = bits.view(torch.float32)
    x = torch.minimum(torch.maximum(x, -127 * s), 127 * s)
    want = torch.round(x / s).clamp(-127, 127).to(torch.int8)
    if layout == "rows":
        view = x.view(rows, 1, cols)                       # (A, Rw, B) = (1, rows, cols)
    else:
        view = x.t().contiguous().view(cols, 1, rows).permute(2, 0, 1)   # rows contiguous
    assert dm._layout_of(view)[2] == (cols if layout == "rows" else 1)
    assert torch.equal(dm.drive_codes(view, s), want)


@pytest.mark.parametrize("shape", STRIDED_SHAPES)
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("adc_bits", [16, 8, 1])
def test_strided_route_vs_codes_front_end_and_plain(card, shape, mode, adc_bits):
    """The strided route is bit-equal to the codes front end fed
    quantize_mttkrp_operands(unfolding) wherever both walks cut the same
    stages (A = 1, B = 1 or B % 32 = 0), within two ADC codes + rtol 2e-4 of
    the plain version everywhere, repeatable, and counted by staging."""
    view, b, c = _strided_case(card, shape, mode, 7 * mode + shape[1])
    rw = shape[mode]
    a, _, bb = dm._unfold_layout(tuple(view.shape), view.stride(), view.data_ptr())
    front = "cols" if bb == 1 else "rows"
    q = dm.quantize_mttkrp_operands(view.reshape(rw, -1).contiguous(), b, c)
    launches, routes = dm.mttkrp_psram_strided.launches, dict(dm.mttkrp_psram_strided.routes)
    passes = dm.drive_scales.launches
    got = dm.mttkrp_psram_strided(view, *q[2:], adc_bits=adc_bits)
    torch.cuda.synchronize()
    assert dm.mttkrp_psram_strided.launches == launches + 1
    assert dm.drive_scales.launches == passes + 1
    assert dm.mttkrp_psram_strided.routes[front] == routes[front] + 1
    assert torch.equal(dm.mttkrp_psram_strided(view, *q[2:], adc_bits=adc_bits), got)
    ring = dict(dm.mttkrp_psram_fused.routes)
    codes = dm.mttkrp_psram_fused(*q, adc_bits=adc_bits)
    assert dm.mttkrp_psram_fused.routes["ring"] == ring["ring"] + 1
    if a == 1 or bb == 1 or bb % 32 == 0:
        assert torch.equal(got, codes)
    want = dm.mttkrp_psram_strided_torch(view, *q[2:], adc_bits=adc_bits)
    bi = min(128, rw)
    fs = want.abs().reshape(rw // bi, -1).amax(dim=1).clamp_min(1e-30)
    lsb = (2.0 * fs / 2 ** adc_bits).repeat_interleave(bi)[:, None]
    assert ((got - want).abs() <= 2 * lsb + 2e-4 * want.abs()).all()
    assert ((codes - want).abs() <= 2 * lsb + 2e-4 * want.abs()).all()


@pytest.mark.parametrize("shape,mode", [(s, m) for s in STRIDED_SHAPES for m in range(3)
                                        if m != 1 or s[2] % 32 == 0])
def test_strided_ring_codes_show_at_24_bits(card, shape, mode):
    """Where both walks cut the same stages, the strided route is bit-equal
    to the codes front end at a 24-bit ADC too, where one code of the
    ring's own staged tile moves the output: the codes the ring computes
    (swizzled or transposed staging, per-lane scale pairs) are
    quantize_symmetric's, not only those of the check kernel."""
    view, b, c = _strided_case(card, shape, mode, 7 * mode + shape[1])
    q = dm.quantize_mttkrp_operands(view.reshape(shape[mode], -1).contiguous(), b, c)
    got = dm.mttkrp_psram_strided(view, *q[2:], adc_bits=24)
    assert torch.equal(got, dm.mttkrp_psram_fused(*q, adc_bits=24))
    assert torch.isfinite(got).all()


def test_psram_op_routes_by_layout(card):
    """``mttkrp_psram_op`` reads an unfolding in place (every mode, as the
    hopper backend permutes it) and gives any other view, e.g. the
    permutation (0, 2, 1), to the codes front end after its eager
    quantization; both within two codes of the plain version."""
    from repro_torch.kernels import ops as tops

    gen = torch.Generator(device=card).manual_seed(9)
    x = torch.randn((128, 24, 64), generator=gen, device=card)
    b = torch.randn((24, 16), generator=gen, device=card)
    c = torch.randn((64, 16), generator=gen, device=card)
    for view, strided in ((x, True), (x.permute(0, 2, 1), False)):
        bb, cc = (b, c) if strided else (c, b)
        strided_n = dm.mttkrp_psram_strided.launches
        ring_n = dm.mttkrp_psram_fused.routes["ring"]
        got = tops.mttkrp_psram_op(view, bb, cc)
        assert dm.mttkrp_psram_strided.launches == strided_n + int(strided)
        assert dm.mttkrp_psram_fused.routes["ring"] == ring_n + int(not strided)
        q = dm.quantize_mttkrp_operands(view.reshape(128, -1).contiguous(), bb, cc)
        want = dm.mttkrp_psram_torch(*q)
        fs = want.abs().amax().clamp_min(1e-30)
        assert ((got - want).abs() <= 2 * (2.0 * fs / 2 ** 16) + 2e-4 * want.abs()).all()


@pytest.mark.parametrize("offset,jk,route", [(0, 200, "partials"), (1, 256, "partials"),
                                             (16, 256, "ring")])
def test_psram_codes_route_by_alignment(card, offset, jk, route):
    """Codes whose rows TMA cannot take (J*K % 16 != 0, or a base off 16
    bytes) stay on the partials kernel, and a forced ring raises; aligned
    codes take the ring, and the partials kernel gives them its own bits
    within two codes."""
    i, k, r = 128, 8, 24
    x0, b, c = _dense_operands(card, i, jk // k, k, r, jk + offset)
    q = dm.quantize_mttkrp_operands(x0, b, c)
    base = torch.empty(q[0].numel() + offset, dtype=torch.int8, device=card)
    qx = base[offset:].view(i, jk).copy_(q[0])
    routes = dict(dm.mttkrp_psram_fused.routes)
    got = dm.mttkrp_psram_fused(qx, *q[1:])
    assert dm.mttkrp_psram_fused.routes[route] == routes[route] + 1
    want = dm.mttkrp_psram_torch(*q)
    lsb = 2.0 * want.abs().amax() / 2 ** 16
    assert ((got - want).abs() <= 2 * lsb + 2e-4 * want.abs()).all()
    if route == "partials":
        with pytest.raises(ValueError, match="ring route needs"):
            dm._launch_codes(qx, *q[1:], bi=128, adc_bits=16, route="ring")
    else:
        other = dm._launch_codes(qx, *q[1:], bi=128, adc_bits=16, route="partials")
        assert ((other - want).abs() <= 2 * lsb + 2e-4 * want.abs()).all()


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
    # D = 256 (the bf16 kernel's 64-key tiles) and the slab kernel (D > 256)
    (1, 8, 2, 320, 320, 256, True, 50.0, 64),
    (1, 4, 2, 100, 100, 256, True, 0.0, 128),
    (1, 8, 2, 128, 384, 256, True, 0.0, 128),
    (1, 8, 2, 256, 256, 256, False, 0.0, 128),
    (1, 4, 2, 320, 320, 320, True, 50.0, 64),
    (1, 8, 2, 384, 128, 512, True, 0.0, 128),
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
    """Shapes the reference refuses raise, and only those: head dims above
    128 run (160 on the bf16 kernel at D = 256, 320 on the slab kernel),
    one launch each on the kernel :func:`kernel_route` names."""
    q = torch.zeros((1, 2, 192, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of bq"):
        fa.flash_attention(q, q, q)
    for d, route in ((160, "wgmma"), (320, "slab")):
        z = torch.ones((1, 2, 64, d), device=card, dtype=torch.bfloat16)
        before = dict(fa.flash_attention.routes)
        got = fa.flash_attention(z, z, z)
        torch.cuda.synchronize()
        assert fa.flash_attention.routes[route] == before[route] + 1
        assert torch.equal(got, z)


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
    # saturate=False: the same launch with the codes unclipped
    got = psram_linear(x, prog, saturate=False)
    torch.cuda.synchronize()
    assert pm.psram_matmul.launches == before + 2
    want = pm.psram_matmul_torch(qx, prog["q"], sx.float(), prog["scale"], saturate=False)
    assert torch.equal(got.reshape(-1, 72), want)


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


# ------------------------------------------------- kernel 2's wgmma route

WGMMA_SHAPES = [
    (17, 4096, 1024, 16), (200, 1040, 144, 16), (8192 + 64, 4096, 1024, 16),   # ragged M
    (300, 1040, 400, 8), (257, 2064, 272, 24),          # K, N multiples of 16, not of a tile
    (17, pm.MAX_K // 16 * 16, 32, 16),                  # K up to MAX_K
    (1024, 4096, 4096, 16), (1024, 4096, 1024, 16),     # the prefill's four shapes,
    (1024, 4096, 14336, 16), (1024, 14336, 4096, 16),   # M cut from 8192 to 1024
]


@pytest.mark.parametrize("m,k,n,adc_bits", WGMMA_SHAPES)
def test_psram_matmul_wgmma_route_bit_equal_and_counted(card, m, k, n, adc_bits):
    """Rows above 16 with operands TMA can take go to the wgmma kernel:
    bit-equal to the plain version and to the tile route, the same bits on
    a second launch, counted as the ``wgmma`` route only."""
    qx, qw, sx, sw = _codes(card, m, k, n, m + k + n)
    before, routes = pm.psram_matmul.launches, dict(pm.psram_matmul.routes)
    got = pm.psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits)
    torch.cuda.synchronize()
    assert pm.psram_matmul.launches == before + 1
    assert pm.psram_matmul.routes == {**routes, "wgmma": routes["wgmma"] + 1}
    assert torch.equal(got, pm.psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits))
    assert torch.equal(pm._launch(qx, qw, sx, sw, adc_bits=adc_bits, route="wgmma"), got)
    assert torch.equal(pm._launch(qx, qw, sx, sw, adc_bits=adc_bits, route="tile"), got)


@pytest.mark.parametrize("offset,route", [(1, "tile"), (4, "tile"), (16, "wgmma")])
def test_psram_matmul_sliced_operands_route_by_alignment(card, offset, route):
    """Operands that start ``offset`` bytes into their storage: off a
    16-byte boundary TMA cannot take them, so they go to the tile kernel and
    a forced wgmma launch raises; every route gives the same bits."""
    m, k, n = 300, 1040, 144
    qx, qw, sx, sw = _codes(card, m, k, n, 7 + offset)
    bx = torch.empty(qx.numel() + offset, dtype=torch.int8, device=card)
    bw = torch.empty(qw.numel() + offset, dtype=torch.int8, device=card)
    ux = bx[offset:].view(m, k).copy_(qx)
    uw = bw[offset:].view(k, n).copy_(qw)
    routes = dict(pm.psram_matmul.routes)
    got = pm.psram_matmul(ux, uw, sx, sw)
    assert pm.psram_matmul.routes[route] == routes[route] + 1
    assert torch.equal(got, pm.psram_matmul_torch(qx, qw, sx, sw))
    if route == "tile":
        with pytest.raises(ValueError, match="wgmma route needs"):
            pm._launch(ux, uw, sx, sw, route="wgmma")
    else:
        assert torch.equal(pm._launch(ux, uw, sx, sw, route="tile"), got)


# --------------------------------------------------- kernel 2's tile route

TILE_CASES = [  # (m, k, n, qx's and qw's offset in bytes, split; 0: _tile_split's)
    (200, 1043, 131, 0, 0, 0),          # K % 16 != 0, odd N
    (200, 1043, 131, 0, 0, 1),
    (200, 1043, 131, 0, 0, 8),
    (130, 1, 257, 0, 0, 0),             # K = 1
    (130, 1, 257, 0, 0, 2),
    (300, 4096, 1000, 0, 0, 0),         # the head's N % 16 = 8: 8-byte copies of qw
    (300, 4096, 1000, 1, 3, 4),         # sliced operands: neither base word-aligned
    (257, 2064, 272, 16, 16, 0),        # M not a multiple of 128; TMA could take it
    (129, 4100, 36, 4, 8, 3),           # a cluster of 3: the tile's rows split unevenly
    (512, 4096, 1000, 0, 0, 0),         # the 1000-class head, split 4 on an H100
]


@pytest.mark.parametrize("m,k,n,ox,ow,split", TILE_CASES)
def test_psram_matmul_tile_route_bit_equal_at_every_split(card, m, k, n, ox, ow, split):
    """The tile route over ragged K and N, sliced operands (the guarded word
    path), M off a tile, K = 1, and K split over clusters of 1 to 8 CTAs:
    bit-equal to the plain version and to the unsplit launch, counted as
    the ``tile`` route."""
    qx, qw, sx, sw = _codes(card, m, k, n, m + k + n + ox)
    bx = torch.empty(qx.numel() + ox, dtype=torch.int8, device=card)
    bw = torch.empty(qw.numel() + ow, dtype=torch.int8, device=card)
    ux = bx[ox:].view(m, k).copy_(qx)
    uw = bw[ow:].view(k, n).copy_(qw)
    routes = dict(pm.psram_matmul.routes)
    got = pm._launch(ux, uw, sx, sw, route="tile", cluster=split)
    torch.cuda.synchronize()
    assert pm.psram_matmul.routes == {**routes, "tile": routes["tile"] + 1}
    want = pm.psram_matmul_torch(qx, qw, sx, sw)
    assert torch.equal(got, want)
    assert torch.equal(pm._launch(ux, uw, sx, sw, route="tile", cluster=1), want)
    if split == 0 and (m, k, n) == (512, 4096, 1000) and _sms() >= 128:
        assert pm._tile_split(m, k, n, _sms()) == 4


def test_psram_matmul_tile_route_refuses_a_bad_split(card):
    qx, qw, sx, sw = _codes(card, 200, 128, 40, 1)
    with pytest.raises(ValueError, match="cluster must be in"):
        pm._launch(qx, qw, sx, sw, route="tile", cluster=9)


# -------------------------------------------- the ordered fold's fold route

FOLD_ROUTE_CASES = [  # (rank, d's offset in floats, gather through an order)
    (32, 0, False), (32, 0, True), (6, 0, True), (40, 1, True), (40, 1, False),
    (3, 1, True), (128, 0, True), (3000, 0, True),
]


@pytest.mark.parametrize("r,offset,gather", FOLD_ROUTE_CASES)
@pytest.mark.parametrize("long_run", [None, 0, 1 << 40], ids=["default", "ring", "warps"])
def test_fold_route_with_and_without_order_bit_equal_to_cpu(card, r, offset, gather, long_run):
    """The fold route, given rows of ``d`` in place or through a gather
    ``order``: runs longer than ``FOLD_LONG_RUN`` (a third of the stream,
    and two neighbours in one CTA), empty rows (a whole CTA's worth too),
    R % 4 != 0, a ``d`` off 16 bytes, a nonzero start; bit-equal to the
    CPU's fold. ``long_run`` 0 sends every run through its CTA's ring, 2**40
    every run to its warp: the same bits."""
    rng = np.random.default_rng(r + offset + 7 * gather)
    rows = 45
    counts = rng.integers(0, 12, size=rows)
    counts[4] = 2000 if r < 1000 else 300                  # a long run
    counts[8] = counts[9] = 2 * of.FOLD_LONG_RUN + 5        # two in one CTA
    counts[[5, *range(16, 24)]] = 0                         # empty rows, one CTA all empty
    ids = np.repeat(np.arange(rows), counts)
    n = len(ids)
    n_d = n + 50 if gather else n
    flat = torch.tensor(rng.standard_normal(n_d * r + offset).astype(np.float32), device=card)
    d = flat[offset:].view(n_d, r)
    order = torch.tensor(rng.permutation(n_d)[:n], device=card) if gather else None
    start = torch.tensor(rng.standard_normal((rows, r)).astype(np.float32), device=card)
    tid = torch.tensor(ids, device=card)
    routes = dict(of.ordered_fold.routes)
    if long_run is None:
        got = of.ordered_fold(start.clone(), d, tid, order=order)
    else:
        got = of._fold_runs(start.clone(), d, of.row_runs(tid, rows), None, 0, rows, 0,
                            order=order, long_run=long_run)
    torch.cuda.synchronize()
    assert of.ordered_fold.routes == {**routes, "fold": routes["fold"] + 1}
    want = of.ordered_fold_torch(start.cpu(), d.cpu(), tid.cpu(),
                                 order=None if order is None else order.cpu())
    assert torch.equal(got.cpu(), want)


def test_fold_route_refuses_an_order_out_of_range(card):
    """On the card too, an ``order`` reaching past ``d`` raises before any
    launch."""
    d = torch.zeros((10, 4), device=card)
    ids = torch.zeros(3, dtype=torch.int64, device=card)
    launches = of.ordered_fold.launches
    with pytest.raises(IndexError, match="outside d's 10 rows"):
        of.ordered_fold(torch.zeros((2, 4), device=card), d, ids,
                        order=torch.tensor([0, 10, 2], device=card))
    assert of.ordered_fold.launches == launches


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_blocked_stream_on_the_card_is_ordered(card, mode):
    """``stream_mttkrp_blocked`` (the ``compiled=False`` sparse path) on the
    card: one segment-sum launch and one ordered fold, BIT-EQUAL to the same
    function on the CPU and the same bits on a second run."""
    from repro_torch.sparse.stream import stream_mttkrp_blocked

    coo = powerlaw_coo(6, (300, 200, 100), nnz=60000, rank=4, alpha=1.6, device=card)
    gen = torch.Generator(device=card).manual_seed(10 + mode)
    fs = tuple(torch.randn((s, 32), generator=gen, device=card) for s in coo.shape)
    csf = csf_for_mode(coo, mode)
    cfg = PsramConfig(rows=64)
    folds, sums = of.ordered_fold.launches, ss.blocked_segment_sum.launches
    chains = ss.blocked_segment_sum.routes["chain"]
    got = stream_mttkrp_blocked(csf, fs, cfg)
    torch.cuda.synchronize()
    assert of.ordered_fold.launches == folds + 1
    assert ss.blocked_segment_sum.launches == sums + 1
    assert ss.blocked_segment_sum.routes["chain"] == chains + 1     # the chain formed inside
    cpu = lambda t: t.cpu()
    csf_cpu = csf_for_mode(COO(indices=cpu(coo.indices), values=cpu(coo.values),
                               shape=coo.shape), mode)
    want = stream_mttkrp_blocked(csf_cpu, tuple(map(cpu, fs)), cfg)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(stream_mttkrp_blocked(csf, fs, cfg), got)


# ------------------------------------------- kernel 5's chain route


CHAIN_SEGMENT_CASES = [  # (nmodes, rank, nnz, bn, ids, zero values)
    (3, 32, 10037, 256, "runs", False),      # a ragged tail: nnz % bn != 0
    (3, 32, 4096, 256, "one", False),        # one segment a block
    (3, 32, 4101, 64, "each", False),        # every row its own segment
    (3, 7, 5000, 100, "runs", False),        # lanes 7..31 idle
    (3, 40, 5000, 128, "runs", False),       # two column tiles, the second ragged
    (3, 64, 5000, 256, "runs", False),
    (3, 128, 3000, 256, "runs", False),
    (4, 32, 6000, 256, "runs", False),
    (5, 32, 6000, 64, "runs", False),
    (3, 32, 6000, 256, "runs", True),        # zero values: +-0.0 chain rows
    (3, 32, 6000, 128, "random", False),     # unsorted ids: slots stored, then reloaded
]


def _chain_segment_operands(card, nmodes, rank, nnz, bn, ids, zeros):
    """A stream of ``nnz`` nonzeros in blocks of ``bn`` (the last one padded),
    its non-target coordinates, values and block-local ids by ``ids``:
    ``runs`` (sorted, random run lengths), ``one`` (one segment a block),
    ``each`` (a segment a row) or ``random`` (unsorted); two slots beyond
    the most a block uses."""
    rng = np.random.default_rng(nnz + rank + nmodes)
    sizes = (50, 40, 30, 20, 10)[:nmodes]
    mode = nmodes - 2
    b = -(-nnz // bn)
    coords = np.stack([rng.integers(0, sizes[d], nnz) for d in range(nmodes) if d != mode], 1)
    vals = rng.standard_normal(nnz).astype(np.float32)
    if zeros:
        vals[rng.random(nnz) < 0.3] = 0.0
    if ids == "runs":
        local = np.cumsum(rng.random((b, bn)) < 0.05, axis=1)
    elif ids == "one":
        local = np.zeros((b, bn))
    elif ids == "each":
        local = np.broadcast_to(np.arange(bn), (b, bn))
    else:
        local = rng.integers(0, 9, (b, bn))
    n_seg = int(local.max()) + 3
    fs = tuple(torch.tensor(rng.standard_normal((s, rank)).astype(np.float32), device=card)
               for s in sizes)
    return (torch.tensor(coords.astype(np.int32), device=card), torch.tensor(vals, device=card),
            torch.tensor(np.ascontiguousarray(local, dtype=np.int32), device=card), fs, mode,
            n_seg)


@pytest.mark.parametrize("nmodes,rank,nnz,bn,ids,zeros", CHAIN_SEGMENT_CASES)
def test_chain_segment_sum_bit_equal_to_the_rows_route(card, nmodes, rank, nnz, bn, ids, zeros):
    """The chain route, which forms the chain rows in the kernel: BIT-EQUAL to
    the rows route over the padded chain (the composition it replaces) and to
    its plain version on the CPU, the same bits on a second launch, one
    launch counted on the chain route."""
    coords, vals, local, fs, mode, n_seg = _chain_segment_operands(card, nmodes, rank, nnz, bn,
                                                                   ids, zeros)
    before = dict(ss.blocked_segment_sum.routes)
    got = ss.blocked_chain_segment_sum(coords, vals, local, fs, mode, n_seg)
    torch.cuda.synchronize()
    assert ss.blocked_segment_sum.routes == {**before, "chain": before["chain"] + 1}
    assert got.shape == (local.shape[0], n_seg, rank)
    rows = ss.blocked_segment_sum(ss.padded_chain(coords, vals, local, fs, mode), local, n_seg)
    assert torch.equal(got, rows)
    cpu = lambda t: t.cpu()
    want = ss.blocked_chain_segment_sum_torch(cpu(coords), cpu(vals), cpu(local),
                                              tuple(map(cpu, fs)), mode, n_seg)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(ss.blocked_chain_segment_sum(coords, vals, local, fs, mode, n_seg), got)


def test_chain_segment_sum_refusals(card):
    """CPU tensors and int64 coordinates are refused before any launch."""
    coords, vals, local, fs, mode, n_seg = _chain_segment_operands(card, 3, 32, 1000, 64,
                                                                   "runs", False)
    before = dict(ss.blocked_segment_sum.routes)
    cpu = lambda t: t.cpu()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.blocked_chain_segment_sum(cpu(coords), cpu(vals), cpu(local), tuple(map(cpu, fs)),
                                     mode, n_seg)
    with pytest.raises(TypeError, match="int32"):
        ss.blocked_chain_segment_sum(coords.long(), vals, local, fs, mode, n_seg)
    assert ss.blocked_segment_sum.routes == before


def test_blocked_stream_on_the_card_checks_coordinates(card):
    """A coordinate outside its factor raises IndexError on the card before
    any launch: the chain route reads what it is given."""
    from repro_torch.sparse.stream import stream_mttkrp_blocked

    coo = powerlaw_coo(4, (30, 20, 10), nnz=2000, rank=4, alpha=1.2, device=card)
    fs = tuple(torch.randn((s, 8), device=card) for s in coo.shape)
    short = fs[:2] + (fs[2][:5],)                       # mode 2's factor: 5 of 10 rows
    before = dict(ss.blocked_segment_sum.routes)
    with pytest.raises(IndexError, match="mode 2"):
        stream_mttkrp_blocked(csf_for_mode(coo, 0), short, PsramConfig(rows=64))
    assert ss.blocked_segment_sum.routes == before


# --------------------------------------------------------- the ordered fold


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_exact_sparse_mttkrp_on_the_card_is_ordered(card, mode):
    """``mttkrp_sparse`` (unsorted COO, int32 and int64 coordinates) and
    ``stream_mttkrp`` on the card: BIT-EQUAL to the same functions on the CPU
    (stream-ordered index_add_, in steps that split the head fiber) and the
    same bits on a second run;
    each call is exactly one launch of the ordered fold's chain route and no
    launch of its fold route."""
    from repro_torch.core.mttkrp import mttkrp_sparse
    from repro_torch.sparse.stream import stream_mttkrp

    coo = powerlaw_coo(5, (300, 200, 100), nnz=60000, rank=4, alpha=1.6, device=card)
    gen = torch.Generator(device=card).manual_seed(mode)
    fs = tuple(torch.randn((s, 32), generator=gen, device=card) for s in coo.shape)
    perm = torch.randperm(coo.nnz, generator=gen, device=card)
    idx, vals = coo.indices[perm], coo.values[perm]
    before = dict(of.ordered_fold.routes)
    got = mttkrp_sparse(idx, vals, fs, mode, coo.shape[mode])
    torch.cuda.synchronize()
    assert of.ordered_fold.routes == {**before, "chain": before["chain"] + 1}
    cpu = lambda t: t.cpu()
    want = mttkrp_sparse(cpu(idx), cpu(vals), tuple(map(cpu, fs)), mode, coo.shape[mode])
    assert torch.equal(got.cpu(), want)
    assert torch.equal(mttkrp_sparse(idx, vals, fs, mode, coo.shape[mode]), got)
    # int64 coordinates: the kept sort hands the kernel int32 ones
    assert torch.equal(mttkrp_sparse(idx.long(), vals, fs, mode, coo.shape[mode]), got)
    csf = csf_for_mode(coo, mode)
    cfg = PsramConfig(rows=64)
    before = dict(of.ordered_fold.routes)
    got_s = stream_mttkrp(csf, fs, cfg, exec_blocks=3)
    torch.cuda.synchronize()
    assert of.ordered_fold.routes == {**before, "chain": before["chain"] + 1}
    csf_cpu = csf_for_mode(COO(indices=cpu(coo.indices), values=cpu(coo.values),
                               shape=coo.shape), mode)
    want_s = stream_mttkrp(csf_cpu, tuple(map(cpu, fs)), cfg, exec_blocks=3)
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(stream_mttkrp(csf, fs, cfg, exec_blocks=3), got_s)


def test_exact_sparse_mttkrp_on_the_card_checks_coordinates(card):
    """A coordinate outside its factor (or a target row outside the output)
    raises IndexError on the card, before any launch, as the CPU's indexing
    does: the chain route reads what it is given, so its callers check the
    coordinates once, where they keep the stream."""
    from repro_torch.core.mttkrp import mttkrp_sparse
    from repro_torch.sparse.stream import stream_mttkrp

    coo = powerlaw_coo(4, (30, 20, 10), nnz=2000, rank=4, alpha=1.2, device=card)
    fs = tuple(torch.randn((s, 8), device=card) for s in coo.shape)
    short = fs[:2] + (fs[2][:5],)                       # mode 2's factor: 5 of 10 rows
    before = dict(of.ordered_fold.routes)
    with pytest.raises(IndexError, match="mode 2"):
        mttkrp_sparse(coo.indices, coo.values, short, 0, 30)
    with pytest.raises(IndexError, match="mode 1"):
        mttkrp_sparse(coo.indices.clone(), coo.values, fs, 1, 12)   # rows 12.. have nonzeros
    with pytest.raises(IndexError, match="mode 2"):
        stream_mttkrp(csf_for_mode(coo, 0), short)
    assert of.ordered_fold.routes == before
    with pytest.raises(IndexError):                     # the CPU refuses the same
        mttkrp_sparse(coo.indices.cpu(), coo.values.cpu(), tuple(f.cpu() for f in short), 0, 30)


CHAIN_CASES = [  # (shape, nnz, rank, mode, factor offset)
    ((300, 200), 30000, 32, 0, 0),               # 2 modes: one factor, no Hadamard
    ((300, 200, 100), 60000, 32, 0, 0),
    ((300, 200, 100), 60000, 16, 1, 0),          # lanes 16..31 of the chain idle
    ((300, 200, 100), 60000, 64, 2, 0),          # two columns a lane
    ((300, 200, 100), 60000, 128, 0, 0),         # four columns a lane
    ((300, 200, 100), 60000, 6, 0, 0),           # R % 4 != 0: 4-byte copies, scalar products
    ((300, 200, 100), 60000, 40, 1, 0),          # not a template rank: runtime loops
    ((300, 200, 100), 20000, 200, 2, 0),         # beyond the templates
    ((300, 200, 100), 60000, 32, 0, 1),          # factors not 16-byte aligned: 4-byte copies
    ((50, 12, 9, 7), 20000, 32, 3, 0),           # 4 modes
    ((12, 9, 8, 7, 6, 5), 20000, 32, 2, 0),      # 6 modes
    ((40, 3000, 200), 400000, 32, 0, 0),         # runs past 32768 nonzeros: 6 producers
    ((40, 3000, 200), 400000, 64, 0, 0),
]


@pytest.mark.parametrize("shape,nnz,rank,mode,offset", CHAIN_CASES)
def test_ordered_chain_fold_bit_equal_to_cpu(card, shape, nnz, rank, mode, offset):
    """The chain route on its own over a CSF's root fibers, from a nonzero
    ``out`` (rows without nonzeros keep their value): BIT-EQUAL to its plain
    version on the CPU, the same bits on a second launch, one launch counted
    on the chain route."""
    from repro_torch.sparse.stream import _chain_stream

    coo = powerlaw_coo(7, shape, nnz=nnz, rank=4, alpha=1.6, device=card)
    csf = csf_for_mode(coo, mode)
    gen = torch.Generator(device=card).manual_seed(rank + mode)
    fs = tuple(torch.randn((s * rank + offset,), generator=gen, device=card)[offset:]
               .view(s, rank) for s in shape)
    start = torch.randn((shape[mode], rank), generator=gen, device=card)
    coords, seg_ptr, seg_rows, longest, *_ = _chain_stream(csf)
    vals = csf.values
    before = dict(of.ordered_fold.routes)
    got = of.ordered_chain_fold(start.clone(), coords, vals, fs, mode, seg_ptr, seg_rows,
                                longest_run=longest)
    torch.cuda.synchronize()
    assert of.ordered_fold.routes == {**before, "chain": before["chain"] + 1}
    cpu = lambda t: t.cpu()
    want = of.ordered_chain_fold_torch(cpu(start), cpu(coords), cpu(vals), tuple(map(cpu, fs)),
                                       mode, cpu(seg_ptr), cpu(seg_rows))
    assert torch.equal(got.cpu(), want)
    again = of.ordered_chain_fold(start.clone(), coords, vals, fs, mode, seg_ptr, seg_rows,
                                  longest_run=longest)
    assert torch.equal(again, got)


PSRAM_CHAIN_CASES = [  # (shape, nnz, rank, mode, adc_bits, zero row)
    ((300, 200, 100), 60000, 32, 0, 16, False),
    ((300, 200, 100), 60000, 32, 2, 4, False),     # a 4-bit ADC
    ((300, 200, 100), 60000, 5, 1, 16, False),     # R % 4 != 0, < 32: 4-byte copies
    ((300, 200, 100), 60000, 20, 0, 8, False),     # not a template rank
    ((300, 200, 100), 60000, 16, 1, 16, False),    # a row is 4 lanes
    ((300, 200, 100), 60000, 48, 2, 16, False),    # kernel 5: two column tiles, whole rows
    ((300, 200, 100), 60000, 64, 0, 16, False),    # a row is 16 lanes; two tiles
    ((300, 200, 100), 20000, 128, 1, 16, False),   # a row is the warp; four tiles
    ((50, 12, 9, 7), 20000, 32, 3, 16, False),     # 4 modes: CP1 through the ADC twice
    ((50, 12, 9, 7), 20000, 48, 0, 4, False),
    ((300, 200, 100), 60000, 32, 0, 16, True),     # all-zero factor rows and values
    ((40, 3000, 200), 400000, 32, 0, 16, False),   # runs past 32768 nonzeros: clusters
    ((50, 12, 9, 7), 20000, 5, 1, 8, False),       # 4 modes at the other ranks and ADCs
    ((50, 12, 9, 7), 20000, 16, 2, 4, False),
    ((50, 12, 9, 7), 20000, 64, 0, 8, False),
    ((50, 12, 9, 7), 20000, 128, 3, 16, False),
    ((300, 200, 100), 30000, 128, 2, 8, False),
    ((300, 200, 100), 60000, 16, 0, 4, False),
]


@pytest.mark.parametrize("shape,nnz,rank,mode,bits,zero", PSRAM_CHAIN_CASES)
def test_quantized_chain_routes_bit_equal_to_cpu(card, shape, nnz, rank, mode, bits, zero):
    """Both chain routes' quantized variants (``psram=True``: the chain of
    ``cp_chain_psram`` formed in the kernel): BIT-EQUAL to their plain
    versions on the CPU, the same bits on a second launch, one launch each
    counted as ``chain_psram``. The ordered fold's over the CSF's root fibers
    from a nonzero ``out``; kernel 5's over the padded blocks of the
    compiled layout (the last block's padding adds nothing); and
    ``stream_mttkrp(psram=True)``, eager and compiled, against the CPU."""
    from repro_torch.sparse.stream import _chain_stream, _segment_blocks, stream_mttkrp

    coo = powerlaw_coo(9, shape, nnz=nnz, rank=4, alpha=1.6, device=card)
    csf = csf_for_mode(coo, mode)
    gen = torch.Generator(device=card).manual_seed(rank + mode + bits)
    fs = [torch.randn((s, rank), generator=gen, device=card) for s in shape]
    vals = csf.values.clone()
    if zero:
        for f in fs:
            f[::3] = 0.0
        vals[::5] = 0.0
    fs = tuple(fs)
    cpu = lambda t: t.cpu()
    fs_cpu = tuple(map(cpu, fs))
    coords, seg_ptr, seg_rows, longest, *_ = _chain_stream(csf)
    start = torch.randn((shape[mode], rank), generator=gen, device=card)
    before = dict(of.ordered_fold.routes)
    got = of.ordered_chain_fold(start.clone(), coords, vals, fs, mode, seg_ptr, seg_rows,
                                longest_run=longest, psram=True, adc_bits=bits)
    torch.cuda.synchronize()
    assert of.ordered_fold.routes == {**before, "chain_psram": before["chain_psram"] + 1}
    want = of.ordered_chain_fold_torch(cpu(start), cpu(coords), cpu(vals), fs_cpu, mode,
                                       cpu(seg_ptr), cpu(seg_rows), psram=True, adc_bits=bits)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(of.ordered_chain_fold(start.clone(), coords, vals, fs, mode, seg_ptr,
                                             seg_rows, longest_run=longest, psram=True,
                                             adc_bits=bits), got)
    local, n_seg = _segment_blocks(csf, 256)[:2]
    before = dict(ss.blocked_segment_sum.routes)
    parts = ss.blocked_chain_segment_sum(coords, vals, local, fs, mode, n_seg, psram=True,
                                         adc_bits=bits)
    torch.cuda.synchronize()
    assert ss.blocked_segment_sum.routes == {**before, "chain_psram": before["chain_psram"] + 1}
    want_parts = ss.blocked_chain_segment_sum_torch(cpu(coords), cpu(vals), cpu(local), fs_cpu,
                                                    mode, n_seg, psram=True, adc_bits=bits)
    assert torch.equal(parts.cpu(), want_parts)
    assert torch.equal(ss.blocked_chain_segment_sum(coords, vals, local, fs, mode, n_seg,
                                                    psram=True, adc_bits=bits), parts)
    if zero:
        return
    csf_cpu = csf_for_mode(COO(indices=cpu(coo.indices), values=cpu(coo.values),
                               shape=coo.shape), mode)
    cfg = PsramConfig(rows=64)
    for compiled in (False, True):
        got_s = stream_mttkrp(csf, fs, cfg, psram=True, adc_bits=bits, compiled=compiled)
        want_s = stream_mttkrp(csf_cpu, fs_cpu, cfg, psram=True, adc_bits=bits,
                               compiled=compiled)
        assert torch.equal(got_s.cpu(), want_s), compiled


def test_quantized_chain_routes_refusals(card):
    """An ADC outside 1..24 bits, and kernel 5 at a rank whose whole rows do
    not fit its slots, are refused before any launch."""
    coords, vals, local, fs, mode, n_seg = _chain_segment_operands(card, 3, 32, 1000, 64,
                                                                   "runs", False)
    before = (dict(ss.blocked_segment_sum.routes), dict(of.ordered_fold.routes))
    with pytest.raises(ValueError, match="1..24"):
        ss.blocked_chain_segment_sum(coords, vals, local, fs, mode, n_seg, psram=True,
                                     adc_bits=25)
    big = tuple(torch.ones((s, 4000), device=card) for s in (50, 40, 30))
    with pytest.raises(ValueError, match="do not fit shared memory"):
        ss.blocked_chain_segment_sum(coords, vals, local, big, mode, n_seg, psram=True)
    seg_ptr = torch.tensor([0, vals.numel()], device=card)
    with pytest.raises(ValueError, match="1..24"):
        of.ordered_chain_fold(torch.zeros((1, 32), device=card), coords, vals, fs, mode,
                              seg_ptr, psram=True, adc_bits=0)
    assert (dict(ss.blocked_segment_sum.routes), dict(of.ordered_fold.routes)) == before


# ------------------------------------------ the quantized chains' quotients


@pytest.mark.parametrize("bits", range(1, 25))
def test_psram_division_adc_equals_fdiv(card, bits):
    """The ADC's quotient acc / lsb through the LSB's reciprocal and two fma
    corrections (``hopper::psram_div``) is ``__fdiv_rn``'s, bit for bit, and
    so is the digitized value, for every integer product in [-127², 127²]
    and -0.0 (which digitizes to +0.0, as the int32 product does)."""
    assert of._division_probe("adc", bits) == (0, 2 ** 63 - 1)


def test_psram_division_value_code_equals_fdiv(card):
    """A nonzero's value code through its scale's reciprocal equals the code
    through ``__fdiv_rn`` for every finite f32 value."""
    assert of._division_probe("value") == (0, 2 ** 63 - 1)


def test_psram_division_row_codes_equal_fdiv(card):
    """A row's codes through its scale's reciprocal equal those through
    ``__fdiv_rn`` and ``quantize_symmetric``'s on the CPU: random rows of
    several magnitudes, ties at code + 1/2 (scales that are powers of 2),
    the row's max itself, all-zero rows, rows under 1e-12 and subnormals."""
    rng = np.random.default_rng(24)
    rows = [rng.standard_normal((2000, 32)) * 10.0 ** rng.integers(-30, 30, (2000, 1))]
    for e in (-3, 0, 5):                               # scale 2^e: x / s is exactly k + 1/2
        tie = (rng.integers(-127, 127, (200, 32)) + 0.5) * 2.0 ** e
        tie[:, 0] = 127 * 2.0 ** e                     # the row's max
        rows.append(tie)
    rows += [np.zeros((4, 32)), rng.standard_normal((50, 32)) * 1e-13,
             rng.standard_normal((50, 32)) * 1e-40]
    x = torch.tensor(np.concatenate(rows).astype(np.float32))
    codes, codes_div = of._division_rows(x.to(card))
    want = quantize_symmetric(x, axis=-1)[0].float()
    assert torch.equal(codes_div.cpu(), want)
    assert torch.equal(codes.cpu(), want)


def _long_run_stream(card, nmodes, rank, heads, shorts, seed):
    """A stream of mode 0 whose first runs have ``heads`` nonzeros each and
    the others ``shorts`` in all (spread over 40 rows), with random
    coordinates, values and factors, on the card: ``(coords, vals, fs,
    seg_ptr, start)``."""
    rng = np.random.default_rng(seed)
    shape = (40 + len(heads),) + (300, 200, 90)[:nmodes - 1]
    rows = np.sort(np.r_[np.repeat(np.arange(len(heads)), heads),
                         rng.integers(len(heads), shape[0], size=shorts)], kind="stable")
    idx = np.stack([rows] + [rng.integers(0, s, size=rows.size) for s in shape[1:]], 1)
    gpu = lambda a: torch.tensor(a, device=card)
    coords = of.chain_coords(gpu(idx), 0)
    vals = gpu(rng.standard_normal(rows.size).astype(np.float32))
    fs = tuple(gpu(rng.standard_normal((s, rank)).astype(np.float32)) for s in shape)
    seg_ptr = gpu(np.searchsorted(rows, np.arange(shape[0] + 1)).astype(np.int64))
    start = gpu(rng.standard_normal((shape[0], rank)).astype(np.float32))
    return coords, vals, fs, seg_ptr, start


@pytest.mark.parametrize("nmodes,rank,heads", [
    (3, 32, (100000, 40000, 32768)),    # the main path's rank; a run of exactly LONG_RUN
    (3, 16, (70000,)),
    (3, 64, (50000, 33000)),
    (3, 128, (40000,)),
    (4, 32, (60000, 35000)),            # 4 modes
    (2, 32, (45000,)),                  # one non-target factor
])
def test_quantized_chain_long_runs_take_clusters(card, nmodes, rank, heads):
    """The quantized chain route at a template rank gives every run of
    ``CHAIN_LONG_RUN`` nonzeros or more a cluster of 8 CTAs in the same
    launch as the short runs' CTAs: BIT-EQUAL to the plain version on the
    CPU, the same bits again, and the same bits as the plain launch in which
    every run is one CTA's (``long_runs`` empty). A run one short of the
    threshold stays a CTA's."""
    coords, vals, fs, seg_ptr, start = _long_run_stream(card, nmodes, rank,
                                                        heads + (32767,), 20000, rank + nmodes)
    long_runs = torch.as_tensor(of.chain_long_runs(seg_ptr.cpu()), device=card)
    assert long_runs.tolist() == list(np.argsort([-h for h in heads], kind="stable"))
    got = of.ordered_chain_fold(start.clone(), coords, vals, fs, 0, seg_ptr,
                                longest_run=max(heads), long_runs=long_runs, psram=True)
    torch.cuda.synchronize()
    layout = of.ordered_fold.last_psram
    assert (layout["clusters"], layout["cluster_ctas"]) == (len(heads), 8)
    cpu = lambda t: t.cpu()
    want = of.ordered_chain_fold_torch(cpu(start), cpu(coords), cpu(vals), tuple(map(cpu, fs)),
                                       0, cpu(seg_ptr), psram=True)
    assert torch.equal(got.cpu(), want)
    again = of.ordered_chain_fold(start.clone(), coords, vals, fs, 0, seg_ptr,
                                  longest_run=max(heads), long_runs=long_runs, psram=True)
    assert torch.equal(again, got)
    plain = of.ordered_chain_fold(start.clone(), coords, vals, fs, 0, seg_ptr,
                                  long_runs=long_runs[:0], psram=True)
    assert of.ordered_fold.last_psram["clusters"] == 0
    assert torch.equal(plain, got)


def test_mttkrp_sparse_psram_long_rows_take_clusters(card):
    """``mttkrp_sparse_psram`` on the card (the ``psram-oracle`` backend's
    path, the COO sorted on the card): its sorted stream keeps the rows of
    ``CHAIN_LONG_RUN`` nonzeros or more, the launch gives each a cluster,
    and the result is the CPU's bits."""
    from repro_torch.core import mttkrp as tm

    rng = np.random.default_rng(31)
    shape = (30, 300, 200)
    rows = np.r_[np.zeros(50000, np.int64), np.full(33000, 7), rng.integers(0, 30, 20000)]
    rng.shuffle(rows)
    idx = np.stack([rows] + [rng.integers(0, s, rows.size) for s in shape[1:]], 1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    fs = [rng.standard_normal((s, 32)).astype(np.float32) for s in shape]
    on = lambda dev: (torch.tensor(idx.astype(np.int32), device=dev),
                      torch.tensor(vals, device=dev),
                      tuple(torch.tensor(f, device=dev) for f in fs))
    got = tm.mttkrp_sparse_psram(*on(card), 0, shape[0])
    torch.cuda.synchronize()
    assert of.ordered_fold.last_psram["clusters"] == 2
    assert torch.equal(got.cpu(), tm.mttkrp_sparse_psram(*on("cpu"), 0, shape[0]))


def test_quantized_chain_route_constants_are_the_librarys(card):
    """The long-run threshold and the cluster are the library's, and so is
    the quantized route's layout (:func:`psram_layout`)."""
    lib, _ = of._chain_entry()
    assert lib.ordered_psram_long_run() == of.CHAIN_LONG_RUN
    assert lib.ordered_psram_cluster() == 8
    for nmodes in range(2, 9):
        for rank in of.TEMPLATE_RANKS:
            for cluster in (False, True):
                assert of._psram_layout(nmodes, rank, cluster) \
                    == psram_layout(nmodes, rank, cluster), (nmodes, rank, cluster)
    assert of._psram_layout(3, 32, False) == (4, 69632)
    assert of._psram_layout(3, 32, True) == (4, 230272)
    assert of._psram_layout(3, 40, False) == (-1, -1)


def psram_layout(nmodes, rank, cluster):
    """The quantized route's layout at a template rank as
    ``csrc/ordered_fold.cu`` documents it (``psram_layout``): ``(producer
    warps, dynamic shared memory)``. A batch is 2 KB of chain rows (512 / R
    nonzeros), 4 KB in a launch with clusters at R >= 32; a producer has 4
    row slots of K such rows and 5 metadata slots; a cluster's rank 0 holds
    a ring of 2 batches a producer of the 7 other ranks and a full and a
    consumed barrier a ring slot; the barriers first."""
    a16 = lambda b: (b + 15) // 16 * 16
    batch = 4096 if cluster and rank >= 32 else 2048
    k, nb = nmodes - 1, batch // (4 * rank)

    def smem(p):
        own, ring = 2 * p * 4, 2 * 7 * p * 2
        bars = a16(8 * (ring if cluster and ring > own else own))
        rings = p * (4 * a16(4 * k * nb * rank) + 5 * a16(4 * nb * (k + 1)))
        return bars + max(rings, 7 * p * 2 * batch if cluster else 0)

    p = 4
    while p > 1 and smem(p) > 232448:
        p -= 1
    return p, smem(p) if smem(p) <= 232448 else -1


def chain_layout(nmodes, rank, longest_run):
    """The chain route's layout as ``csrc/ordered_fold.cu`` documents it
    (``chain_layout``): ``(nonzeros a batch, producer warps, the CTA's
    dynamic shared memory)``, -1 bytes where one producer does not fit.
    Per producer 4 row slots of K x nb factor rows and 5 metadata slots of
    nb x K coordinates and nb values (each 16-byte aligned); before them a
    full and an empty barrier a row slot; after them R running sums."""
    a16 = lambda b: (b + 15) // 16 * 16
    k = nmodes - 1
    if rank in (16, 32, 64, 128):
        nb = {16: 32, 32: 32, 64: 16, 128: 8}[rank]
    else:
        nb = max(1, min(32, 4096 // (4 * k * rank)))

    def smem(p):
        warp = 4 * a16(4 * k * nb * rank) + 5 * a16(4 * nb * (k + 1))
        return a16(16 * p * 4) + p * warp + a16(4 * rank)

    p = 6 if longest_run >= 32768 else 2
    while p > 1 and smem(p) > 232448:
        p -= 1
    return nb, p, smem(p) if smem(p) <= 232448 else -1


@pytest.mark.parametrize("nmodes,rank,head,nb,producers", [
    (3, 32, 1000, 32, 2),           # the short runs' default
    (3, 32, 40000, 32, 6),          # a run of 32768 nonzeros or more
    (4, 32, 40000, 32, 4),          # more modes: fewer producers fit
    (5, 32, 40000, 32, 3),
    (6, 40, 40000, 5, 6),           # not a template rank: the batch sized by its rows
    (3, 600, 40000, 1, 6),          # a batch of one nonzero: a slot a nonzero
    (3, 4000, 6000, 1, 1),          # one producer reuses each slot as soon as it is freed
    (3, 6, 1000, 32, 2),            # 4-byte copies, scalar products
])
def test_ordered_chain_fold_layouts_give_the_same_bits(card, nmodes, rank, head, nb, producers):
    """Every layout the chain route takes (producer warps and, where R is not
    a template rank, nonzeros a batch), reached through the stream's shape
    (modes, rank, its longest run) as the library lays it out, gives the
    CPU's bits on a head run longer than every ring."""
    assert chain_layout(nmodes, rank, head)[:2] == (nb, producers)
    assert of._chain_smem(nmodes, rank, head) == chain_layout(nmodes, rank, head)[2]
    rng = np.random.default_rng(nmodes * rank + head)
    shape = (40,) + (300, 200, 90, 80, 70, 60, 50)[:nmodes - 1]
    rows = np.sort(np.r_[np.zeros(head, np.int64), rng.integers(1, 40, size=2000)],
                   kind="stable")
    idx = np.stack([rows] + [rng.integers(0, s, size=rows.size) for s in shape[1:]], 1)
    coords = of.chain_coords(torch.tensor(idx), 0)
    vals = torch.tensor(rng.standard_normal(rows.size).astype(np.float32))
    fs = tuple(torch.tensor(rng.standard_normal((s, rank)).astype(np.float32)) for s in shape)
    seg_ptr = torch.tensor(np.searchsorted(rows, np.arange(41)).astype(np.int64))
    start = torch.tensor(rng.standard_normal((40, rank)).astype(np.float32))
    want = of.ordered_chain_fold_torch(start.clone(), coords, vals, fs, 0, seg_ptr)
    gpu = lambda t: t.to(card)
    got = of.ordered_chain_fold(gpu(start), gpu(coords), gpu(vals), tuple(map(gpu, fs)), 0,
                                gpu(seg_ptr), longest_run=head)
    assert torch.equal(got.cpu(), want)


def test_chain_route_constants_are_the_librarys(card):
    """The wrapper's mode limit is the library's, and the library lays a
    chain-route CTA out as its source says (:func:`chain_layout`) for 2 to
    8 modes, template ranks and others, short and long runs; it refuses
    fewer than 2 or more than 8 modes and a rank whose stages do not fit."""
    lib, _ = of._chain_entry()
    assert lib.ordered_chain_max_modes() == of.CHAIN_MAX_MODES
    for nmodes in range(2, 9):
        for rank in (6, 16, 32, 40, 64, 128, 200, 600, 4000, 20000):
            for longest in (0, 32767, 32768):
                assert of._chain_smem(nmodes, rank, longest) \
                    == chain_layout(nmodes, rank, longest)[2], (nmodes, rank, longest)
    assert of._chain_smem(1, 32) == of._chain_smem(9, 32) == -1
    assert of._chain_smem(3, 20000) == -1
    with pytest.raises(ValueError, match="do not fit shared memory"):
        out = torch.zeros((2, 20000), device=card)
        of.ordered_chain_fold(out, torch.zeros((1, 2), dtype=torch.int32, device=card),
                              torch.ones(1, device=card),
                              tuple(torch.ones((2, 20000), device=card) for _ in range(3)), 0,
                              torch.tensor([0, 1, 1], device=card), None)


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
                                     (torch.bfloat16, 80), (torch.float32, 160),
                                     (torch.bfloat16, 192), (torch.float16, 200),
                                     (torch.bfloat16, 300), (torch.float32, 300)])
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
