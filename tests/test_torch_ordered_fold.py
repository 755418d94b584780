"""The ordered fold's chain route (``kernels.ordered_fold.ordered_chain_fold``)
held against the JAX reference on the CPU, and its fold route's gather
index (``ordered_fold(..., order=)``) against the gathered copy it replaces.

The chain route forms each contribution ``d_p = v_p · ⊙ other-factor rows``
(``cp_chain_exact``'s rounded multiplies) and adds it into its run's row in
stream order. Its plain version, ``ordered_chain_fold_torch``, must be
**equal** to the reference's exact sparse MTTKRPs: the eager
``repro.sparse.stream.stream_mttkrp`` (runs = the CSF's root fibers) and
``repro.core.mttkrp.mttkrp_sparse`` (one global ``segment_sum`` over an
unsorted COO; runs = the stable sort's rows). The kernel itself runs only on
a card (``tests/test_torch_cuda_kernels.py``); here its wrapper is held to
what it refuses. The fold route's plain version with ``order`` must equal
``index_select`` and then the fold, bit for bit, and the blocked path that
reads its partials through it must equal the composition it replaces (the
partials gathered first) and stay within rtol 1e-5 of the reference's
``stream_mttkrp_blocked``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mttkrp as jm
from repro.sparse import formats as jf
from repro.sparse import stream as jstream
from repro.core.psram import PsramConfig as JPsramConfig
from repro.sparse import synth as jsynth
from repro_torch import convert
from repro_torch.core.mttkrp import cp_chain_exact
from repro_torch.core.psram import PsramConfig
from repro_torch.kernels import ordered_fold as of
from repro_torch.kernels.ops import blocked_chain_segment_sum_op
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
    coords, seg_ptr, seg_rows, *_ = tstream._chain_stream(tc)
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
    coords, seg_ptr, seg_rows, *_ = tstream._chain_stream(csf)
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


# ------------------------------------------------- the fold route's gather index


def _fold_operands(n, rows, rank, extra, seed):
    """Sorted ids with a long run, empty rows and a nonzero start; ``d`` with
    ``extra`` rows more than the stream and ``order`` a seeded choice of
    its rows (repeats included)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows, size=n)
    ids[: n // 3] = 2                                   # a long run
    ids[(ids == 4) | (ids == 5)] = 6                    # rows 4, 5 empty
    ids = np.sort(ids)
    d = rng.standard_normal((n + extra, rank)).astype(np.float32)
    order = rng.integers(0, n + extra, size=n)
    start = rng.standard_normal((rows, rank)).astype(np.float32)
    return (torch.tensor(start), torch.tensor(d), torch.tensor(ids), torch.tensor(order))


@pytest.mark.parametrize("n,rows,rank,extra,seed", [
    (500, 11, 6, 0, 1), (500, 11, 6, 37, 2), (2000, 40, 32, 100, 3), (64, 3, 3, 5, 4),
    (0, 4, 8, 9, 5),
])
def test_fold_plain_version_with_order_equals_index_select_then_fold(n, rows, rank, extra, seed):
    """``ordered_fold_torch(..., order=)`` and the CPU wrapper: EQUAL to
    ``index_select`` then the fold, and to the serial in-order fold
    ``out[ids[i]] += d[order[i]]`` from ``out``'s values."""
    start, d, ids, order = _fold_operands(n, rows, rank, extra, seed)
    want = of.ordered_fold_torch(start.clone(), d.index_select(0, order), ids)
    got = of.ordered_fold_torch(start.clone(), d, ids, order=order)
    assert torch.equal(got, want)
    assert torch.equal(of.ordered_fold(start.clone(), d, ids, order=order), want)
    serial = start.clone()
    for i in range(n):
        serial[ids[i]] = serial[ids[i]] + d[order[i]]
    assert torch.equal(got, serial)


@pytest.mark.parametrize("change,error,match", [
    (lambda o: o.int(), TypeError, "int64"),
    (lambda o: o.view(-1, 2), TypeError, r"\(P,\)"),
    (lambda o: o.to("meta"), ValueError, "device"),
    (lambda o: o[:-1], ValueError, "does not match"),
    (lambda o: torch.cat([o[:-1], torch.tensor([107])]), IndexError, "outside d's 107 rows"),
    (lambda o: torch.cat([torch.tensor([-1]), o[1:]]), IndexError, r"spans \[-1,"),
])
def test_fold_wrappers_refuse_a_bad_order(change, error, match):
    """The wrapper and its plain version refuse an ``order`` of another
    dtype, shape or device, one whose length is not the stream's, and one
    that reaches outside ``d``'s rows; nothing is launched or folded."""
    start, d, ids, order = _fold_operands(100, 9, 4, 7, 6)
    bad = change(order)
    before = (of.ordered_fold.launches, dict(of.ordered_fold.routes))
    for fold in (of.ordered_fold, of.ordered_fold_torch):
        out = start.clone()
        with pytest.raises(error, match=match):
            fold(out, d, ids, order=bad)
        assert torch.equal(out, start)
    assert (of.ordered_fold.launches, of.ordered_fold.routes) == before


def test_order_is_checked_again_after_an_in_place_write():
    """Every call reads ``order``'s range anew: an in-place write that takes
    it past ``d``'s rows after a fold is refused by the next call, and
    written back it folds as before."""
    start, d, ids, order = _fold_operands(100, 9, 4, 7, 7)
    of.ordered_fold(start.clone(), d, ids, order=order)
    order[5] = d.shape[0]
    with pytest.raises(IndexError, match="outside"):
        of.ordered_fold(start.clone(), d, ids, order=order)
    order[5] = 0
    assert torch.equal(of.ordered_fold(start.clone(), d, ids, order=order),
                       of.ordered_fold_torch(start.clone(), d.index_select(0, order), ids))


BLOCKED_CASES = [((40, 30, 20), 11, mode, 16) for mode in range(3)] \
    + [((14, 11, 9, 8), 12, mode, 7) for mode in range(4)]


@pytest.fixture(scope="module")
def blocked_tensors():
    """One seeded reference tensor of 3 and one of 4 modes, with numpy
    factors at rank 32."""
    out = {}
    for shape, key in {(40, 30, 20): 11, (14, 11, 9, 8): 12}.items():
        coo = jsynth.powerlaw_coo(jax.random.PRNGKey(key), shape, nnz=1500, rank=3, alpha=1.1)
        fs = [np.random.default_rng(60 + d).standard_normal((s, 32)).astype(np.float32)
              for d, s in enumerate(shape)]
        out[shape] = (coo, fs)
    return out


@pytest.mark.parametrize("shape,key,mode,rows", BLOCKED_CASES, ids=lambda v: str(v))
def test_blocked_path_reads_partials_in_place(blocked_tensors, shape, key, mode, rows):
    """``stream_mttkrp_blocked`` folds its partials through ``order``: EQUAL
    to the composition it replaces (the partials gathered into fold order
    by ``index_select``, then the fold), and within rtol 1e-5 of the
    reference's ``stream_mttkrp_blocked`` (its Pallas kernel interpreted),
    in every mode."""
    coo, fs = blocked_tensors[shape]
    jcsf = jf.csf_for_mode(coo, mode)
    csf = convert.csf(jcsf.shape, jcsf.mode_order, jcsf.fids, jcsf.fptr,
                      np.asarray(jcsf.values), device="cpu")
    tfs = tuple(convert.factors(fs, device="cpu"))
    cfg = PsramConfig(rows=rows)
    got = tstream.stream_mttkrp_blocked(csf, tfs, cfg)
    local, n_seg, order, fold_rows, fold_runs, _ = tstream._segment_blocks(csf, rows)
    coords = tstream._chain_stream(csf)[0]
    partials = blocked_chain_segment_sum_op(coords, csf.values, local, tfs, mode, n_seg)
    want = of.ordered_fold(torch.zeros((shape[mode], 32)),
                           partials.reshape(-1, 32).index_select(0, order), fold_rows,
                           runs=fold_runs)
    assert torch.equal(got, want)
    ref = np.asarray(jstream.stream_mttkrp_blocked(jcsf, tuple(jnp.asarray(f) for f in fs),
                                                   JPsramConfig(rows=rows), backend="interpret"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("ptr,long_run,want", [
    ([0, 3, 3, 100, 105, 400, 401, 401], 64, [4, 2]),
    ([100, 105, 400, 401, 401], 4, [1, 0]),
    ([0, 3, 3, 100, 105, 400, 401, 401], 1000, []),
    ([0, 70, 140, 140, 210], 64, [0, 1, 3]),              # equal lengths keep their order
], ids=["default", "from_an_offset", "none", "ties"])
def test_long_runs_listed_longest_first(ptr, long_run, want):
    """The fold route's long runs (more than ``long_run`` rows) of host
    offsets, longest first, ties in run order; the same from a numpy array
    and from a CPU tensor."""
    assert of.find_long_runs(np.array(ptr), long_run).tolist() == want
    assert of.find_long_runs(torch.tensor(ptr), long_run).tolist() == want


@pytest.mark.parametrize("rows", [4, 16])
def test_blocked_long_runs_are_those_of_its_runs(blocked_tensors, rows):
    """The long runs ``_segment_blocks`` keeps for the blocked path's fold
    are ``find_long_runs`` of its fold runs: the power-law head row's run
    at 4-row blocks (73 partials), none at 16-row blocks."""
    coo, _ = blocked_tensors[(40, 30, 20)]
    jcsf = jf.csf_for_mode(coo, 0)
    csf = convert.csf(jcsf.shape, jcsf.mode_order, jcsf.fids, jcsf.fptr,
                      np.asarray(jcsf.values), device="cpu")
    *_, fold_runs, long_runs = tstream._segment_blocks(csf, rows)
    assert long_runs.dtype == torch.int64
    assert long_runs.tolist() == of.find_long_runs(fold_runs.numpy()).tolist()
    assert len(long_runs) == (1 if rows == 4 else 0)
