"""``repro_torch.data.tensors`` held against the JAX package's
``repro.data.tensors`` on the CPU.

``jax.random`` draws cannot be matched bit for bit, so the port is held to
the reference in structure and distribution, and its arithmetic on its own
draws to the reference's arithmetic on the same draws: ``lowrank_dense``'s
tensor is the reference's ``reconstruct`` of the port's factors (noise
included), ``sparse_coo``'s values the reference's formula on the port's
coordinates and factors. The draws are replayed here from the documented
generator: a CPU ``torch.Generator`` seeded with ``seed``, in call order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cp_als import reconstruct as j_reconstruct
from repro.data import tensors as jtensors
from repro_torch import data
from repro_torch.core.cp_als import cp_als
from repro_torch.data import tensors

SHAPE, RANK = (24, 20, 16), 4


def _replay(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_exported_from_data():
    assert data.lowrank_dense is tensors.lowrank_dense
    assert data.sparse_coo is tensors.sparse_coo


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_lowrank_dense_is_the_references_reconstruct_of_its_factors(noise):
    """Shape, dtype, device, the factors' draws, and the tensor equal to the
    reference's ``reconstruct`` of the port's factors plus the same noise
    draws (rtol 1e-6, atol 1e-6 for entries near zero)."""
    x, fs = tensors.lowrank_dense(3, SHAPE, RANK, noise=noise, device="cpu")
    jx, jfs = jtensors.lowrank_dense(jax.random.PRNGKey(3), SHAPE, RANK,
                                     noise=noise)
    assert tuple(x.shape) == tuple(jx.shape) == SHAPE
    assert x.dtype == torch.float32 and str(jx.dtype) == "float32"
    assert x.device.type == "cpu" and all(f.device.type == "cpu" for f in fs)
    assert [tuple(f.shape) for f in fs] == [tuple(f.shape) for f in jfs]
    gen = _replay(3)
    for f, s in zip(fs, SHAPE):
        assert torch.equal(f, torch.rand((s, RANK), generator=gen))
    want = np.asarray(j_reconstruct([jnp.asarray(f.numpy()) for f in fs]))
    if noise > 0:
        want = want + noise * torch.randn(SHAPE, generator=gen).numpy()
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-6, atol=1e-6)


def test_lowrank_dense_factors_are_uniform():
    """Uniform [0, 1) factors, as the reference's ``jax.random.uniform``:
    every entry in range, the mean within 5 sigma of 1/2."""
    _, fs = tensors.lowrank_dense(0, (400, 300, 200), 8, device="cpu")
    flat = torch.cat([f.reshape(-1) for f in fs]).double()
    assert 0.0 <= float(flat.min()) and float(flat.max()) < 1.0
    sigma = (1 / 12) ** 0.5 / flat.numel() ** 0.5
    assert abs(float(flat.mean()) - 0.5) <= 5 * sigma


def test_sparse_coo_values_are_the_references_formula():
    """Shapes, dtypes, the coordinates' and factors' draws, and the values
    equal to the reference's formula applied to the port's coordinates and
    factors (rtol 1e-6)."""
    nnz = 3000
    idx, vals, shape = tensors.sparse_coo(5, SHAPE, nnz, rank=RANK, device="cpu")
    jidx, jvals, jshape = jtensors.sparse_coo(jax.random.PRNGKey(5), SHAPE,
                                              nnz, rank=RANK)
    assert shape == jshape == SHAPE
    assert tuple(idx.shape) == tuple(jidx.shape) == (nnz, len(SHAPE))
    assert idx.dtype == torch.int32 and str(jidx.dtype) == "int32"
    assert vals.dtype == torch.float32 and str(jvals.dtype) == "float32"
    assert tuple(vals.shape) == tuple(jvals.shape) == (nnz,)
    gen = _replay(5)
    cols = [torch.randint(0, s, (nnz,), generator=gen) for s in SHAPE]
    assert torch.equal(idx, torch.stack(cols, 1).to(torch.int32))
    fs = [jnp.asarray(torch.rand((s, RANK), generator=gen).numpy()) for s in SHAPE]
    jidx_port = jnp.asarray(idx.numpy())
    want = jnp.ones((nnz,))
    for d in range(len(SHAPE)):
        want = want * jnp.sum(fs[d][jidx_port[:, d]], axis=1) / RANK
    np.testing.assert_allclose(vals.numpy(), np.asarray(want), rtol=1e-6)


def test_sparse_coo_coordinates_in_bounds_and_uniform():
    """Every coordinate within its mode, and each mode's marginal uniform:
    every row's count within 5 sigma of ``nnz / size`` (binomial)."""
    shape, nnz = (50, 40, 30), 60_000
    idx, _, _ = tensors.sparse_coo(1, shape, nnz, device="cpu")
    for d, s in enumerate(shape):
        col = idx[:, d].long()
        assert int(col.min()) >= 0 and int(col.max()) < s
        counts = torch.bincount(col, minlength=s).double()
        p = 1 / s
        sigma = (nnz * p * (1 - p)) ** 0.5
        assert float((counts - nnz * p).abs().max()) <= 5 * sigma


@pytest.mark.parametrize("make", [
    lambda seed: tensors.lowrank_dense(seed, SHAPE, RANK, noise=0.05, device="cpu")[0],
    lambda seed: tensors.sparse_coo(seed, SHAPE, 500, device="cpu")[1],
    lambda seed: tensors.sparse_coo(seed, SHAPE, 500, device="cpu")[0],
], ids=["lowrank_dense", "sparse_coo_values", "sparse_coo_indices"])
def test_same_seed_same_bits_other_seed_other_tensor(make):
    a, b, c = make(9), make(9), make(10)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tensors.lowrank_dense(0, SHAPE, RANK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tensors.sparse_coo(0, SHAPE, 10)


def test_cp_als_reaches_the_planted_rank():
    """The premise of a fit gate that can fail: exact CP-ALS at the planted
    rank reaches fit >= 0.99 on a noiseless ``lowrank_dense`` tensor."""
    x, _ = tensors.lowrank_dense(0, (40, 32, 24), RANK, device="cpu")
    st = cp_als(x, rank=RANK, n_iter=60, seed=1)
    assert st.fit >= 0.99
