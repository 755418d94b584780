"""The pSRAM int8 matmul of the port held against the JAX reference on the CPU.

The plain PyTorch version (what the wrapper uses for CPU tensors; what the
CUDA kernel is held bit-equal to on the card) is fed the *reference's own*
int8 codes and scales, so the comparison is of the kernel arithmetic alone:
integer accumulation is exact in both packages, and the ADC epilogue is the
same f32 arithmetic — the target is equality, and equality is what was
measured on every case below (no ADC tie one code apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.quantization import quantize_symmetric as jq_quantize
from repro.kernels import ref as jref
from repro.kernels.psram_matmul import psram_matmul as j_psram_matmul
from repro.kernels.psram_matmul import psram_matmul_xla
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.psram_matmul import psram_matmul, psram_matmul_torch


def _t(a):
    return torch.tensor(np.asarray(a))


def _reference_operands(m, k, n, seed=0):
    """Float operands from a numpy seed, quantized by the reference exactly
    as its kernel tests do (per-row x, per-column w)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    qx, sx = jq_quantize(jnp.asarray(x), axis=-1)
    qw, sw = jq_quantize(jnp.asarray(w), axis=0)
    return qx, qw, sx.reshape(m, 1), sw.reshape(1, n)


@pytest.mark.parametrize("m,k,n", [
    (8, 16, 8),
    (64, 128, 32),
    (128, 512, 64),
    (16, 2048, 8),      # 127^2*K > 2^24: the reference's int32 branch
    (7, 33, 9),         # nothing a multiple of a tile
])
@pytest.mark.parametrize("adc_bits", [16, 8])
def test_plain_version_equals_reference_oracle_and_xla(m, k, n, adc_bits):
    ops = _reference_operands(m, k, n)
    want_ref = np.asarray(jref.psram_matmul_ref(*ops, adc_bits=adc_bits))
    want_xla = np.asarray(psram_matmul_xla(*ops, adc_bits=adc_bits))
    t_ops = tuple(_t(o) for o in ops)
    got = psram_matmul_torch(*t_ops, adc_bits=adc_bits).numpy()
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_xla)
    # the wrapper takes the plain version for CPU tensors, and the "ref"
    # oracle of the port is the same function
    np.testing.assert_array_equal(psram_matmul(*t_ops, adc_bits=adc_bits).numpy(), got)
    np.testing.assert_array_equal(
        tref.psram_matmul_ref(*t_ops, adc_bits=adc_bits).numpy(), got)


def test_plain_version_equals_interpreted_pallas_kernel():
    """One small case through the reference's Pallas kernel body itself
    (interpret mode), multi-step K."""
    ops = _reference_operands(16, 64, 16, seed=1)
    want = np.asarray(j_psram_matmul(*ops, bm=8, bn=8, bk=32, interpret=True))
    got = psram_matmul_torch(*(_t(o) for o in ops)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_counts_no_launch_on_cpu_and_checks_operands():
    ops = tuple(_t(o) for o in _reference_operands(4, 8, 4))
    before = psram_matmul.launches
    psram_matmul(*ops)
    assert psram_matmul.launches == before       # CPU: plain version, no launch
    qx, qw, sx, sw = ops
    with pytest.raises(TypeError):
        psram_matmul(qx.to(torch.int32), qw, sx, sw)
    with pytest.raises(ValueError):
        psram_matmul(qx, qw[:-1], sx, sw)
    with pytest.raises(ValueError):
        psram_matmul(qx, qw, sx.reshape(-1), sw)


@pytest.mark.parametrize("m,k,n", [(16, 32, 8), (7, 33, 9), (16, 2048, 8)])
@pytest.mark.parametrize("lowering", ["auto", "torch", "ref"])
def test_psram_matmul_op_within_envelope(m, k, n, lowering):
    """Float in, float out: inside the documented 8-bit + ADC envelope
    (rel < 0.05) of ``x @ w``, and within 1e-6 relative of the reference op
    (whose jitted scales may sit one ulp from the port's)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    got = kops.psram_matmul_op(_t(x), _t(w), lowering=lowering).numpy()
    rel = np.linalg.norm(got - x @ w) / np.linalg.norm(x @ w)
    assert rel < 0.05
    from repro.kernels.ops import psram_matmul_op as j_op
    want = np.asarray(j_op(jnp.asarray(x), jnp.asarray(w), backend="xla"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_store_quantization_cache_identity_keyed():
    """The stored operand's quantization is cached on tensor identity with a
    weakref guard: same tensor object hits, an equal-valued copy misses (new
    store), a dead tensor's reused id never serves stale codes, and results
    never change either way."""
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((8, 16)).astype(np.float32))
    w = _t(rng.standard_normal((16, 8)).astype(np.float32))
    first = kops.psram_matmul_op(x, w, lowering="torch")
    hit = kops._stored((w,), "matmul_w", kops._store_matmul_weights)
    again = kops._stored((w,), "matmul_w", kops._store_matmul_weights)
    assert all(a is b for a, b in zip(hit, again))            # pure cache hit
    w_copy = w.clone()                                        # equal values, new id
    miss = kops._stored((w_copy,), "matmul_w", kops._store_matmul_weights)
    assert miss[0] is not hit[0]
    second = kops.psram_matmul_op(x, w_copy, lowering="torch")
    np.testing.assert_array_equal(first.numpy(), second.numpy())
    # id reuse: forge an entry under w_other's key whose weakref points at a
    # different (live) tensor — the guard must reject it and re-store
    w_other = _t(rng.standard_normal((16, 8)).astype(np.float32))
    key = ("matmul_w", id(w_other))
    import weakref
    kops._STORE_CACHE[key] = ((weakref.ref(w),), hit)
    fresh = kops._stored((w_other,), "matmul_w", kops._store_matmul_weights)
    assert fresh[0] is not hit[0]
    np.testing.assert_array_equal(
        fresh[0].numpy(), kops._store_matmul_weights(w_other)[0].numpy())


def test_explicit_cuda_lowering_raises_on_cpu_tensors():
    x, w = torch.zeros((4, 8)), torch.zeros((8, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        kops.psram_matmul_op(x, w, lowering="cuda")
    with pytest.raises(ValueError, match="unknown kernel lowering"):
        kops.psram_matmul_op(x, w, lowering="pallas")


@pytest.mark.parametrize("m", [1, 3, 8, 16])
@pytest.mark.parametrize("k,n", [(33, 37), (1043, 129), (4096, 72)])
def test_decode_shapes_equal_reference_oracle_and_xla(m, k, n):
    """The rows the decode route takes (M <= 16), at odd and deep K and a
    ragged N: the plain version it is held bit-equal to on the card equals
    the reference's oracle and XLA twin."""
    ops = _reference_operands(m, k, n, seed=m * 7 + k)
    want_ref = np.asarray(jref.psram_matmul_ref(*ops))
    want_xla = np.asarray(psram_matmul_xla(*ops))
    t_ops = tuple(_t(o) for o in ops)
    got = psram_matmul(*t_ops).numpy()
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_xla)


def test_route_and_k_limit_are_checked():
    from repro_torch.kernels.psram_matmul import MAX_K, M_DECODE, _launch

    assert 8 <= M_DECODE <= 16      # the served decode rows (8) take the decode route
    assert 128 * 128 * MAX_K < 2 ** 31 <= 128 * 128 * (MAX_K + 1)
    ops = tuple(_t(o) for o in _reference_operands(4, 8, 4))
    with pytest.raises(ValueError, match="route"):
        _launch(*ops, route="split")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _launch(*ops, route="decode")


# the route rules, written out: decode rows; else wgmma where TMA takes the
# operands (16-byte bases, K and N multiples of 16); else the mma.sync tiles
ROUTE_KN = [
    (4096, 14336, True), (4096, 4096, True), (4096, 1024, True), (14336, 4096, True),
    (1040, 144, True),                        # multiples of 16, not of a tile
    (4100, 14336, True), (4096, 14344, True), (33, 9, True), (1043, 131, True),
    (4096, 14336, False),                     # a sliced or unaligned base
    (0, 16, True),
]


@pytest.mark.parametrize("m", [1, 16, 17, 512, 8192])
@pytest.mark.parametrize("k,n,aligned", ROUTE_KN)
def test_route_by_shape_and_alignment(m, k, n, aligned):
    from repro_torch.kernels.psram_matmul import M_DECODE, _route

    assert M_DECODE == 16
    if m <= 16:
        want = "decode"
    elif aligned and k > 0 and k % 16 == 0 and n % 16 == 0:
        want = "wgmma"
    else:
        want = "tile"
    assert _route(m, k, n, aligned) == want


@pytest.mark.parametrize("offset,aligned", [(0, True), (1, False), (8, False), (16, True)])
def test_alignment_of_sliced_operands(offset, aligned):
    """A view that starts ``offset`` bytes into its storage: TMA takes it
    only on a 16-byte boundary."""
    from repro_torch.kernels.psram_matmul import _aligned

    base = torch.zeros(4096 + 64, dtype=torch.int8)
    assert base.data_ptr() % 16 == 0
    view = base[offset:offset + 4096].view(64, 64)
    assert _aligned(view, base) is aligned
    assert _aligned(base) is True


@pytest.mark.parametrize("route", [None, "wgmma", "tile", "decode"])
def test_launch_raises_on_cpu_tensors(route):
    from repro_torch.kernels.psram_matmul import ROUTES, _launch, psram_matmul as pm

    assert set(pm.routes) == set(ROUTES) == {"wgmma", "tile", "decode"}
    ops = tuple(_t(o) for o in _reference_operands(32, 64, 32))
    before = dict(pm.routes)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _launch(*ops, route=route)
    assert pm.routes == before


@pytest.mark.parametrize("m,k,n,sms,want", [
    (8192, 4096, 4096, 132, 1), (8192, 4096, 1024, 132, 1),      # the served prefill's
    (8192, 4096, 14336, 132, 1), (8192, 14336, 4096, 132, 1),    # four projections
    (512, 4096, 1000, 132, 4),            # the 1000-class head: 32 tiles, 128 CTAs
    (512, 4096, 1000, 64, 2),             # fewer SMs, a smaller split
    (512, 4096, 14336, 132, 1),           # 448 tiles already fill the card
    (77, 1043, 131, 132, 4),              # 2 tiles, 17 stages: at least 4 stages a CTA
    (200, 128, 131, 132, 1),              # 2 stages: too few to split
    (17, 1, 8, 132, 1),                   # K = 1
])
def test_tile_split_by_shape_and_sm_count(m, k, n, sms, want):
    """The tile route's K split, chosen by shape and SM count alone (no
    library needed): 1 where the tiles already fill the card, more where a
    grid of tiles would leave most SMs idle; a power of two up to
    ``MAX_TILE_SPLIT``, at most one CTA an SM once split, and every CTA
    keeps ``MIN_TILE_STAGES`` stages of K."""
    from repro_torch.kernels.psram_matmul import (MAX_TILE_SPLIT, MIN_TILE_STAGES, TILE,
                                                  _tile_split)

    split = _tile_split(m, k, n, sms)
    assert split == want
    assert split in (1, 2, 4, 8) and split <= MAX_TILE_SPLIT
    if split > 1:
        assert -(-m // TILE) * -(-n // TILE) * split <= sms
        assert split * MIN_TILE_STAGES <= -(-k // 64)


def _planted_full_scale(m, k, n, seed):
    """x (m, k) and w (k, n) from a numpy seed with row 0 of x at its
    absolute maximum everywhere and column 1 of w at one magnitude, their
    signs matched: both quantize to +-127 with equal signs, so that row and
    column accumulate the full scale 127^2 K, whose unclipped ADC code is
    levels / 2 (one past the rail)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) / 8
    signs = np.where(rng.random(k) < 0.5, -1.0, 1.0).astype(np.float32)
    x[0] = 0.75 * signs
    w[:, 1] = 0.125 * signs
    return x, w


@pytest.mark.parametrize("m", [8, 40])
def test_unsaturated_full_scale_code_equals_reference(m):
    """``psram_linear(saturate=False)`` on the planted full-scale row: bit for
    bit the reference's (run op by op, as the port's bf16 test runs it), and
    one LSB above ``saturate=True`` at that element and equal everywhere
    else. The scales-only gradient through the unclipped codes matches
    ``jax.grad`` of the reference."""
    from repro.core import photonic_layer as jpl
    from repro_torch.core import photonic_layer as tpl
    from repro_torch.core.quantization import QMAX, quantize_symmetric

    k, n, bits = 256, 24, 16
    x, w = _planted_full_scale(m, k, n, seed=m)
    jprog = jpl.program_weights(jnp.asarray(w))
    with jax.disable_jit():
        want = np.asarray(jpl.psram_linear(jnp.asarray(x), jprog, adc_bits=bits, saturate=False))
    prog = {key: _t(v) for key, v in jprog.items()}
    xt = torch.tensor(x)
    got = tpl.psram_linear(xt, prog, adc_bits=bits, saturate=False)
    np.testing.assert_array_equal(got.numpy(), want)
    sat = tpl.psram_linear(xt, prog, adc_bits=bits)
    # the codes: the planted element is levels / 2 unclipped, the rail clipped
    qx, sx = quantize_symmetric(xt, axis=-1)
    assert int(qx[0].abs().min()) == QMAX and int(prog["q"][:, 1].abs().min()) == QMAX
    ones_m, ones_n = torch.ones((m, 1)), torch.ones((1, n))
    lsb = 2.0 * QMAX * QMAX * k / 2 ** bits
    codes = [torch.round(psram_matmul_torch(qx, prog["q"], ones_m, ones_n, adc_bits=bits,
                                            saturate=s) / lsb) for s in (False, True)]
    assert codes[0][0, 1] == 2 ** bits // 2 and codes[1][0, 1] == 2 ** bits // 2 - 1
    differ = (got != sat).nonzero().tolist()
    assert differ == [[0, 1]]
    assert torch.equal(codes[0] - codes[1], (codes[0] != codes[1]).float())
    # the gradient through the scales, unclipped codes and all
    g = np.random.default_rng(m + 1).standard_normal((m, n)).astype(np.float32)

    def jloss(xx, scale):
        prog_j = {"q": jprog["q"], "scale": scale}
        return jnp.sum(jpl.psram_linear(xx, prog_j, adc_bits=bits, saturate=False) * g)

    jgx, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jprog["scale"])
    xg = xt.clone().requires_grad_(True)
    sg = prog["scale"].clone().requires_grad_(True)
    y = tpl.psram_linear(xg, {"q": prog["q"], "scale": sg}, adc_bits=bits, saturate=False)
    (y * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgx).max()))
    np.testing.assert_allclose(sg.grad.numpy(), np.asarray(jgs), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgs).max()))
