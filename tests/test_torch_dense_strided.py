"""The dense psram MTTKRP read in place: the unfolding's layout rule and the
strided entry's plain version, held against the JAX reference on the CPU.

On the card ``mttkrp_psram_strided`` reads the permuted 3-mode view where it
lies and drive-quantizes each tile as it stages it; what the CPU can check
is the pure layout rule that picks that route (``_unfold_layout``), the row
scales' plain twin, and the plain version the kernel is held against there.

Tolerances: against the reference's op (``repro.kernels.ops.mttkrp_psram_op``
on the transposed tensor) two ADC codes of each ``bi``-row tile's full scale
plus rtol 1e-5, as ``test_torch_dense_mttkrp.py::test_ops_vs_reference_ops``
states: the port quantizes for itself and jitted JAX scales sit one ulp off
torch's on a few rows. Against the port's own CPU op: equal.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core.quantization import quantize_symmetric
from repro_torch.kernels import mttkrp as tk
from repro_torch.kernels import ops as tops

SHAPE = (8, 12, 20)                     # (I, J, K): every mode's rows 16-byte aligned
I, J, K = SHAPE


def _layout(t):
    return tk._unfold_layout(tuple(t.shape), t.stride(), t.data_ptr())


def _perm(mode):
    return [mode] + [d for d in range(3) if d != mode]


# ---------------------------------------------------------------- layout rule

# the three unfoldings (the mode first, the others in order) and the other
# three permutations, which TMA cannot read as an unfolding
LAYOUTS = {
    (0, 1, 2): (1, I, J * K),
    (1, 0, 2): (I, J, K),
    (2, 0, 1): (I * J, K, 1),
    (0, 2, 1): None,
    (1, 2, 0): None,
    (2, 1, 0): None,
}


@pytest.mark.parametrize("perm", list(itertools.permutations(range(3))))
def test_unfold_layout_of_every_permutation(perm):
    x = torch.zeros(SHAPE)
    assert x.data_ptr() % 16 == 0
    assert _layout(x.permute(perm)) == LAYOUTS[perm]


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_unfold_layout_addresses_the_unfolding(mode):
    """Row r, column (a, b) of the layout is element (a * Rw + r) * B + b of
    the base: the unfolding ``reshape`` makes."""
    x = torch.arange(I * J * K, dtype=torch.float32).reshape(SHAPE)
    a, rw, b = _layout(x.permute(_perm(mode)))
    unfolding = x.permute(_perm(mode)).reshape(rw, -1)
    flat = x.reshape(-1)
    r = torch.arange(rw)[:, None]
    col = torch.arange(a * b)[None]
    assert torch.equal(unfolding, flat[(col // b * rw + r) * b + col % b])


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_unfold_layout_refuses_an_unaligned_base(mode):
    base = torch.zeros(I * J * K + 4)
    x = base[1:1 + I * J * K].view(SHAPE)     # a sliced storage offset: 4 bytes in
    assert x.data_ptr() % 16 == 4
    assert _layout(x.permute(_perm(mode))) is None
    assert _layout(base[4:].view(SHAPE).permute(_perm(mode))) is not None


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_unfold_layout_refuses_strides_off_16_bytes(mode):
    """J odd and K = 6: the rows of every unfolding are 24 * J, 24 or (mode
    2, rows contiguous) the columns 24 bytes apart."""
    x = torch.zeros((4, 5, 6))
    assert _layout(x.permute(_perm(mode))) is None


@pytest.mark.parametrize("shape,strides", [
    ((2 ** 31, 4, 4), (16, 4, 1)),            # Rw past a 32-bit row index
    ((4, 2 ** 16, 2 ** 15), (2 ** 31, 2 ** 15, 1)),   # J*K past the 32-bit stage walk
    ((2, 3), (3, 1)),                          # not 3 modes
])
def test_unfold_layout_refuses_what_a_tensor_map_cannot_take(shape, strides):
    assert tk._unfold_layout(shape, strides, 0) is None


def test_unfold_layout_ignores_the_stride_of_a_unit_mode():
    """A mode of size 1 carries any stride; the layout found addresses the
    same values (one row of 320 for mode 1 of (16, 1, 20))."""
    x = torch.zeros((16, 1, 20))
    assert _layout(x.permute(1, 0, 2)) == (1, 1, 320)
    assert _layout(x.permute(2, 0, 1)) == (16, 20, 1)
    assert _layout(torch.zeros((1, 8, 12)).permute(0, 2, 1)) is None


# ------------------------------------------------------ plain version vs ref

def _case(seed, rank=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    fs = [rng.standard_normal((n, rank)).astype(np.float32) for n in SHAPE]
    return x, fs


def _operands(x, fs, mode):
    others = [d for d in range(3) if d != mode]
    tx = convert.dense(x, device="cpu").permute(_perm(mode))
    tb, tc = (convert.dense(fs[d], device="cpu") for d in others)
    return tx, tb, tc, tk.quantize_mttkrp_operands(tx.reshape(SHAPE[mode], -1), tb, tc)[2:]


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("adc_bits", [16, 8])
def test_strided_plain_vs_reference_op(mode, adc_bits):
    x, fs = _case(31 + mode)
    others = [d for d in range(3) if d != mode]
    want = np.asarray(jops.mttkrp_psram_op(jnp.transpose(jnp.asarray(x), _perm(mode)),
                                           jnp.asarray(fs[others[0]]),
                                           jnp.asarray(fs[others[1]]),
                                           backend="xla", adc_bits=adc_bits))
    tx, _, _, qf = _operands(x, fs, mode)
    got = tk.mttkrp_psram_strided_torch(tx, *qf, adc_bits=adc_bits).numpy()
    i, r = want.shape
    bi = min(128, i)
    fs_ = np.maximum(np.abs(want.reshape(i // bi, -1)).max(axis=1), 1e-30)
    lsb = np.repeat(2.0 * fs_ / 2 ** adc_bits, bi)[:, None]
    assert (np.abs(got - want) <= 2 * lsb + 1e-5 * np.abs(want)).all()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_strided_plain_equal_to_the_cpu_op(mode):
    """The strided entry (its plain version on the CPU) gives the CPU op's
    bits on the same permuted view, and launches nothing."""
    x, fs = _case(41 + mode)
    others = [d for d in range(3) if d != mode]
    tx, tb, tc, qf = _operands(x, fs, mode)
    want = tops.mttkrp_psram_op(tx, tb, tc)
    launches, passes = tk.mttkrp_psram_strided.launches, tk.drive_scales.launches
    assert torch.equal(tk.mttkrp_psram_strided_torch(tx, *qf), want)
    assert torch.equal(tk.mttkrp_psram_strided(tx, *qf), want)
    assert tk.drive_scales(tx).dtype == torch.float32
    assert (tk.mttkrp_psram_strided.launches, tk.drive_scales.launches) == (launches, passes)
    assert tuple(want.shape) == (SHAPE[mode], fs[others[0]].shape[1])


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cpu_op_keeps_the_eager_unfolding(mode):
    """On CPU tensors ``mttkrp_psram_op`` is what it was: the unfolding,
    ``quantize_symmetric`` per row, then the plain kernel version."""
    x, fs = _case(51 + mode)
    tx, tb, tc, qf = _operands(x, fs, mode)
    qx, sx = quantize_symmetric(tx.reshape(SHAPE[mode], -1).contiguous(), axis=-1)
    want = tk.mttkrp_psram_torch(qx, sx.to(torch.float32), *qf)
    assert torch.equal(tops.mttkrp_psram_op(tx, tb, tc), want)
    assert torch.equal(tops.mttkrp_psram_op(tx, tb, tc, lowering="torch"), want)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_drive_scales_and_codes_plain_twins(mode):
    """The row scales' plain twin is bit-equal to ``quantize_symmetric``'s
    scale (``x.abs().amax`` over the row), and the codes' twin to its codes;
    an all-zero row keeps the 1e-12 floor."""
    x, _ = _case(61 + mode)
    x = convert.dense(x, device="cpu")
    x[(slice(None),) * mode + (0,)] = 0.0                 # row 0 of this mode's unfolding
    view = x.permute(_perm(mode))
    q, s = quantize_symmetric(view.reshape(SHAPE[mode], -1), axis=-1)
    sx = tk.drive_scales(view)
    assert sx.dtype == torch.float32 and tuple(sx.shape) == (SHAPE[mode], 1)
    assert torch.equal(sx, s)
    assert torch.equal(sx.reshape(-1),
                       view.abs().reshape(SHAPE[mode], -1).amax(dim=-1).clamp_min(1e-12)
                       / torch.tensor(127.0))
    assert float(sx[0]) == pytest.approx(1e-12 / 127, rel=1e-6)
    assert torch.equal(tk.drive_codes(view, sx), q)


def test_drive_codes_checks_its_scales():
    x = convert.dense(_case(73)[0], device="cpu")
    sx = tk.drive_scales(x)
    for bad in (sx[:-1], sx.reshape(1, -1), sx.double()):
        with pytest.raises(ValueError, match="sx must be"):
            tk.drive_codes(x, bad)


def test_strided_entry_checks_its_operands():
    x, fs = _case(71)
    tx, _, _, (qb, sb, qc, sc) = _operands(x, fs, 0)
    with pytest.raises(ValueError, match="3-mode"):
        tk.mttkrp_psram_strided(tx[0], qb, sb, qc, sc)
    with pytest.raises(TypeError):
        tk.mttkrp_psram_strided(tx.double(), qb, sb, qc, sc)
    with pytest.raises(ValueError, match="view against"):
        tk.mttkrp_psram_strided(tx, qc, sc, qb, sb)
    with pytest.raises(ValueError, match="I % bi"):
        tk.mttkrp_psram_strided(tx, qb, sb, qc, sc, bi=3)
    with pytest.raises(ValueError, match="K % bk"):
        tk.mttkrp_psram_strided(tx, qb, sb, qc, sc, bk=8)


@pytest.mark.parametrize("jk,offset,route", [
    (960, 0, "ring"), (960, 4, "partials"), (30, 0, "partials"), (2 ** 31, 0, "partials"),
])
def test_codes_route_rule(jk, offset, route):
    assert tk._codes_route(jk, 1024 + offset) == route


@pytest.mark.parametrize("a,b,front,stages", [
    (1, 960, "rows", 30), (12, 20, "rows", 12), (12, 64, "rows", 24),
    (96, 1, "cols", 3), (1, 960, "codes", 30), (1, 970, "codes", 31),
])
def test_ring_stage_count(a, b, front, stages):
    """A stage never straddles ``a`` where the view is staged by rows; the
    walks cut the same stages where A = 1, B = 1 or B % 32 = 0."""
    assert tk._n_stages(a, b, front) == stages
