"""The ordered fold's chain route (``kernels.ordered_fold.ordered_chain_fold``)
held against the JAX reference on the CPU.

The chain route forms each contribution ``d_p = v_p · ⊙ other-factor rows``
(``cp_chain_exact``'s rounded multiplies) and adds it into its run's row in
stream order. Its plain version, ``ordered_chain_fold_torch``, must be
**equal** to the reference's exact sparse MTTKRPs: the eager
``repro.sparse.stream.stream_mttkrp`` (runs = the CSF's root fibers) and
``repro.core.mttkrp.mttkrp_sparse`` (one global ``segment_sum`` over an
unsorted COO; runs = the stable sort's rows). The kernel itself runs only on
a card (``tests/test_torch_cuda_kernels.py``); here its wrapper is held to
what it refuses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mttkrp as jm
from repro.sparse import formats as jf
from repro.sparse import stream as jstream
from repro.sparse import synth as jsynth
from repro_torch.core.mttkrp import cp_chain_exact
from repro_torch.core.psram import PsramConfig
from repro_torch.kernels import ordered_fold as of
from repro_torch.sparse import formats as tf
from repro_torch.sparse import stream as tstream
from repro_torch.sparse import synth as tsynth


def _pair(seed_key, shape, nnz, alpha):
    key = jax.random.PRNGKey(seed_key)
    ref = jsynth.powerlaw_coo(key, shape, nnz=nnz, rank=4, alpha=alpha)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    port = tsynth.powerlaw_coo(seed, shape, nnz=nnz, rank=4, alpha=alpha, device="cpu")
    return ref, port


def _factors(shape, rank, seed):
    rng = np.random.default_rng(seed)
    fs = [rng.standard_normal((s, rank)).astype(np.float32) for s in shape]
    return tuple(jnp.asarray(f) for f in fs), tuple(torch.tensor(f) for f in fs)


def _runs_of(ids: np.ndarray, rows: int) -> torch.Tensor:
    return torch.tensor(np.searchsorted(ids, np.arange(rows + 1)).astype(np.int64))


STREAMS = [  # (seed key, shape, nnz, alpha, mode): skewed 3-mode, and 4 modes
    (11, (40, 30, 20), 3000, 1.6, 0),
    (11, (40, 30, 20), 3000, 1.6, 1),
    (11, (40, 30, 20), 3000, 1.6, 2),
    (2, (9, 8, 7, 6), 900, 0.5, 0),
    (2, (9, 8, 7, 6), 900, 0.5, 3),
]


@pytest.mark.parametrize("seed_key,shape,nnz,alpha,mode", STREAMS)
def test_chain_plain_version_equals_reference_stream_mttkrp(seed_key, shape, nnz, alpha, mode):
    """Over a CSF's stream with its root fibers as the runs: EQUAL to the
    reference's eager exact ``stream_mttkrp``."""
    ref, port = _pair(seed_key, shape, nnz, alpha)
    jc, tc = jf.csf_for_mode(ref, mode), tf.csf_for_mode(port, mode)
    jfs, tfs = _factors(shape, 6, seed=mode)
    want = np.asarray(jstream.stream_mttkrp(jc, jfs))
    coords, seg_ptr, seg_rows, _, _ = tstream._chain_stream(tc)
    out = torch.zeros((shape[mode], 6))
    got = of.ordered_chain_fold_torch(out, coords, tc.values, tfs, mode, seg_ptr, seg_rows)
    assert got is out
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,mode", [((30, 24, 18), 0), ((30, 24, 18), 1),
                                        ((30, 24, 18), 2), ((9, 8, 7, 6), 2)])
def test_chain_plain_version_equals_reference_mttkrp_sparse(shape, mode):
    """An unsorted COO with duplicate coordinates and a long scattered run,
    stably sorted by its target row, rows as runs (empty ones included):
    EQUAL to the reference's one global ``segment_sum``."""
    rng = np.random.default_rng(50 + mode + len(shape))
    idx = rng.integers(0, shape, size=(2000, len(shape))).astype(np.int32)
    idx[:500, mode] = 3                                      # a long run
    idx[:, mode][idx[:, mode] == 5] = 4                       # row 5 empty
    rng.shuffle(idx)
    vals = rng.standard_normal(2000).astype(np.float32)
    jfs, tfs = _factors(shape, 5, seed=mode)
    want = np.asarray(jm.mttkrp_sparse(jnp.asarray(idx), jnp.asarray(vals), jfs, mode,
                                       shape[mode]))
    perm = np.argsort(idx[:, mode], kind="stable")
    coords = of.chain_coords(torch.tensor(idx[perm]), mode)
    got = of.ordered_chain_fold_torch(torch.zeros((shape[mode], 5)), coords,
                                      torch.tensor(vals[perm]), tfs, mode,
                                      _runs_of(idx[perm, mode], shape[mode]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cuts", [1, 7, 60])
def test_chain_plain_version_runs_cut_anywhere_from_a_nonzero_start(cuts):
    """Runs cut at arbitrary stream positions (inside a row's run too) and
    folded from a nonzero ``out``: the serial in-order fold, and two calls
    over consecutive segments compose into one."""
    _, port = _pair(11, (40, 30, 20), 3000, 1.6)
    csf = tf.csf_for_mode(port, 0)
    idx, vals = csf.expanded_indices(), csf.values
    coords = of.chain_coords(idx, 0)
    rid = csf.row_of_nonzero().astype(np.int64)
    rng = np.random.default_rng(cuts)
    starts = np.flatnonzero(np.r_[True, rid[1:] != rid[:-1]])
    cut = np.union1d(starts, rng.integers(1, csf.nnz, size=cuts))
    seg_ptr = torch.tensor(np.r_[cut, csf.nnz].astype(np.int64))
    seg_rows = torch.tensor(rid[cut])
    _, tfs = _factors(csf.shape, 4, seed=cuts)
    start = torch.tensor(rng.standard_normal((40, 4)).astype(np.float32))
    whole = of.ordered_chain_fold_torch(start.clone(), coords, vals, tfs, 0, seg_ptr, seg_rows)
    d = cp_chain_exact(idx, vals, tfs, 0)
    serial = start.clone()
    for p in range(csf.nnz):
        serial[rid[p]] = serial[rid[p]] + d[p]
    assert torch.equal(whole, serial)
    half = len(seg_rows) // 2
    two = of.ordered_chain_fold_torch(start.clone(), coords, vals, tfs, 0, seg_ptr[:half + 1],
                                      seg_rows[:half])
    two = of.ordered_chain_fold_torch(two, coords, vals, tfs, 0, seg_ptr[half:], seg_rows[half:])
    assert torch.equal(two, whole)


@pytest.mark.parametrize("exec_blocks", [None, 1, 2, 3, 7])
def test_stream_mttkrp_on_the_cpu_same_bits_for_every_exec_blocks(exec_blocks):
    """``exec_blocks`` shapes the CPU's temporaries only: every step size
    gives the chain route's plain version's bits (steps of 8 nonzeros split
    the head fiber across many steps)."""
    _, port = _pair(11, (40, 30, 20), 3000, 1.6)
    csf = tf.csf_for_mode(port, 0)
    assert csf.fiber_lengths().max() > 16 * 8, "no fiber spans many steps"
    _, tfs = _factors(csf.shape, 5, seed=9)
    coords, seg_ptr, seg_rows, _, _ = tstream._chain_stream(csf)
    want = of.ordered_chain_fold_torch(torch.zeros((40, 5)), coords, csf.values, tfs, 0,
                                       seg_ptr, seg_rows)
    got = tstream.stream_mttkrp(csf, tfs, PsramConfig(rows=8), exec_blocks=exec_blocks)
    assert torch.equal(got, want)


def _chain_args(nmodes=3, n=50, rank=4, device="cpu"):
    rng = np.random.default_rng(nmodes)
    shape = (6,) * nmodes
    idx = torch.tensor(np.sort(rng.integers(0, 6, size=(n, nmodes)), axis=0).astype(np.int32))
    return {
        "out": torch.zeros((6, rank), device=device),
        "coords": of.chain_coords(idx, 0).to(device),
        "values": torch.ones(n, device=device),
        "factors": tuple(torch.ones((s, rank), device=device) for s in shape),
        "mode": 0, "seg_ptr": _runs_of(idx[:, 0].numpy(), 6).to(device), "seg_rows": None,
    }


@pytest.mark.parametrize("change,error,match", [
    ({}, ValueError, "CUDA"),                                       # CPU tensors
    ({"nmodes": 9}, ValueError, "up to 8 modes"),
    ({"coords": lambda a: a["coords"][:, :1]}, ValueError, "does not match"),
    ({"coords": lambda a: a["coords"].t()}, ValueError, "does not match"),   # (K, n)
    ({"values": lambda a: a["values"][:10]}, ValueError, "does not match"),
    ({"factors": lambda a: a["factors"][:2] + (torch.ones(6, 5),)}, ValueError, "rank columns"),
    ({"seg_rows": lambda a: torch.zeros(3, dtype=torch.int64)}, ValueError, "seg_rows"),
    ({"mode": lambda a: 3}, ValueError, "not one of"),
    ({"factors": lambda a: a["factors"][:1], "coords": lambda a: a["coords"][:, :0]},
     ValueError, "at least 2 modes"),
    ({"values": lambda a: a["values"].double()}, TypeError, "float32"),
])
def test_chain_wrapper_refuses_what_the_kernel_does_not_take(change, error, match):
    """The wrapper launches only on CUDA tensors and raises, with a pointed
    message, on more than ``CHAIN_MAX_MODES`` modes and on mismatched
    shapes or dtypes (checked before the device, so here on the CPU)."""
    args = _chain_args(nmodes=change.get("nmodes", 3))
    for key, fn in change.items():
        if key != "nmodes":
            args[key] = fn(args)
    with pytest.raises(error, match=match):
        of.ordered_chain_fold(**args)
    if match not in ("CUDA", "up to 8 modes"):     # the plain version checks the same
        with pytest.raises(error, match=match):
            of.ordered_chain_fold_torch(**args)
