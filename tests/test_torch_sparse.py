"""repro_torch.sparse (formats, synth, stream layout) and the exact sparse
MTTKRP held against the JAX reference on the CPU.

Containers, the generator and the stream layout are numpy host code in both
packages: their arrays must be **equal**. The exact MTTKRP paths fold each
row in stream order, as XLA's scatter does: **equal** to the reference's
(``test_exact_sparse_mttkrp_equals_the_reference_segment_sum``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mttkrp as jm
from repro.sparse import formats as jf
from repro.sparse import stream as jstream
from repro.sparse import synth as jsynth
from repro_torch import convert
from repro_torch.core import mttkrp as tm
from repro_torch.core.psram import PsramConfig
from repro_torch.sparse import formats as tf
from repro_torch.sparse import stream as tstream
from repro_torch.sparse import synth as tsynth


def _seed_of(key) -> int:
    """The int the reference generator turns its key into (synth.py)."""
    return int(jax.random.randint(key, (), 0, 2 ** 31 - 1))


def _pair(seed_key=3, shape=(30, 24, 18), nnz=800, alpha=1.1, rank=4):
    key = jax.random.PRNGKey(seed_key)
    ref = jsynth.powerlaw_coo(key, shape, nnz=nnz, rank=rank, alpha=alpha)
    port = tsynth.powerlaw_coo(_seed_of(key), shape, nnz=nnz, rank=rank,
                               alpha=alpha, device="cpu")
    return ref, port


def _factors(shape, rank, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, rank)).astype(np.float32) for s in shape]


def _assert_same_coo(port, ref):
    assert tuple(port.shape) == tuple(ref.shape)
    assert port.indices.dtype == torch.int32 and port.values.dtype == torch.float32
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))


def _assert_same_csf(port, ref):
    assert port.shape == ref.shape and port.mode_order == ref.mode_order
    for a, b in zip(port.fids, ref.fids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.fptr, ref.fptr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(port.expanded_indices().numpy(),
                                  np.asarray(ref.expanded_indices()))
    np.testing.assert_array_equal(port.fiber_lengths(), ref.fiber_lengths())
    np.testing.assert_array_equal(port.row_of_nonzero(), ref.row_of_nonzero())


@pytest.mark.parametrize("shape,nnz,alpha", [
    ((30, 24, 18), 800, 1.1), ((40, 30, 20), 1500, 1.1), ((9, 8, 7, 6), 600, 0.0),
])
def test_powerlaw_coo_same_seed_same_tensor(shape, nnz, alpha):
    ref, port = _pair(shape=shape, nnz=nnz, alpha=alpha)
    _assert_same_coo(port, ref)
    assert port.mode_order == ref.mode_order
    port.validate()
    np.testing.assert_array_equal(
        tsynth.powerlaw_fiber_lengths(5, 50, 2000), jsynth.powerlaw_fiber_lengths(5, 50, 2000))
    assert dataclasses.asdict(tsynth.FiberStats.of(port.fiber_lengths())) \
        == dataclasses.asdict(jsynth.FiberStats.of(ref.fiber_lengths()))


def test_powerlaw_coo_with_noise_and_other_mode():
    key = jax.random.PRNGKey(9)
    ref = jsynth.powerlaw_coo(key, (12, 30, 10), nnz=500, mode=1, noise=0.1)
    port = tsynth.powerlaw_coo(_seed_of(key), (12, 30, 10), nnz=500, mode=1,
                               noise=0.1, device="cpu")
    _assert_same_coo(port, ref)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_sorted_coo_and_csf_round_trips_equal_reference(mode):
    ref, port = _pair()
    order = (mode,) + tuple(d for d in range(3) if d != mode)
    _assert_same_coo(tf.SortedCOO.from_coo(port, order),
                     jf.SortedCOO.from_coo(ref, order))
    jc, tc = jf.csf_for_mode(ref, mode), tf.csf_for_mode(port, mode)
    tc.validate()
    _assert_same_csf(tc, jc)
    _assert_same_coo(tc.to_coo(), jc.to_coo())
    # root slices keep coordinates
    n_roots = len(jc.fids[0])
    _assert_same_csf(tc.slice_roots(1, n_roots - 1), jc.slice_roots(1, n_roots - 1))
    # a CSF rebuilt from the reference's fields through convert is the same tree
    carried = convert.csf(jc.shape, jc.mode_order, jc.fids, jc.fptr,
                          np.asarray(jc.values), device="cpu")
    _assert_same_csf(carried, jc)


def test_unsorted_duplicates_dense_and_blocked_equal_reference():
    rng = np.random.default_rng(4)
    shape = (6, 5, 4)
    idx = rng.integers(0, [6, 5, 4], size=(200, 3)).astype(np.int32)   # many duplicates
    vals = rng.standard_normal(200).astype(np.float32)
    ref = jf.COO(indices=jnp.asarray(idx), values=jnp.asarray(vals), shape=shape)
    port = convert.coo(idx, vals, shape, device="cpu")
    assert port.nnz == ref.nnz and port.density == ref.density
    js, ts = (jf.SortedCOO.from_coo(ref, (2, 0, 1), dedupe=True),
              tf.SortedCOO.from_coo(port, (2, 0, 1), dedupe=True))
    _assert_same_coo(ts, js)
    ts.validate()
    np.testing.assert_array_equal(ts.fiber_lengths(), js.fiber_lengths())
    np.testing.assert_allclose(port.to_dense().numpy(), np.asarray(ref.to_dense()),
                               rtol=1e-6, atol=1e-6)
    dense = np.asarray(js.to_dense())
    _assert_same_coo(tf.COO.from_dense(torch.tensor(dense)),
                     jf.COO.from_dense(jnp.asarray(dense)))
    jb, tb = jf.BlockedCOO.from_sorted(js, 16), tf.BlockedCOO.from_sorted(ts, 16)
    assert tb.block_ptr == jb.block_ptr and tb.n_blocks == jb.n_blocks
    tb.validate()
    _assert_same_csf(tf.CSF.from_coo(port, (1, 2, 0), dedupe=True),
                     jf.CSF.from_coo(ref, (1, 2, 0), dedupe=True))
    with pytest.raises(ValueError):
        convert.coo(idx + 10, vals, shape, device="cpu").validate()


@pytest.mark.parametrize("rows,exec_blocks", [(256, 32), (16, 4), (16, 1), (8, 3), (64, 2)])
@pytest.mark.parametrize("mode", [0, 2])
def test_stream_layout_equals_reference(rows, exec_blocks, mode):
    ref, port = _pair(seed_key=7, shape=(40, 30, 20), nnz=1500)
    jc, tc = jf.csf_for_mode(ref, mode), tf.csf_for_mode(port, mode)
    want = jstream.stream_layout(jc, rows, exec_blocks)
    got = tstream.stream_layout(tc, rows, exec_blocks)
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    assert tstream.stream_layout(tc, rows, exec_blocks) is got       # cached
    # the layout tuple survives the trip through convert unchanged
    carried = convert.layout(*[np.asarray(a) for a in want[:4]], want[4], device="cpu")
    for g, c in zip(got[:4], carried[:4]):
        assert g.dtype == c.dtype and torch.equal(g, c)


def test_four_mode_layout_equals_reference():
    ref, port = _pair(seed_key=2, shape=(9, 8, 7, 6), nnz=900, alpha=0.5)
    jc, tc = jf.csf_for_mode(ref, 3), tf.csf_for_mode(port, 3)
    want, got = jstream.stream_layout(jc, 32, 4), tstream.stream_layout(tc, 32, 4)
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_exact_sparse_mttkrp_paths_vs_reference(mode):
    """``mttkrp_sparse`` (COO) and the eager ``stream_mttkrp`` (CSF) within
    1e-5 relative of the reference's (float adds in another order)."""
    ref, port = _pair(seed_key=7, shape=(40, 30, 20), nnz=1500)
    fs = _factors(ref.shape, 5)
    jfs, tfs = tuple(jnp.asarray(f) for f in fs), tuple(torch.tensor(f) for f in fs)
    want = np.asarray(jm.mttkrp_sparse(ref.indices, ref.values, jfs, mode, ref.shape[mode]))
    got = tm.mttkrp_sparse(port.indices, port.values, tfs, mode, port.shape[mode])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
    jc, tc = jf.csf_for_mode(ref, mode), tf.csf_for_mode(port, mode)
    want_s = np.asarray(jstream.stream_mttkrp(jc, jfs))
    for cfg, eb in ((None, None), (PsramConfig(rows=16), 2)):
        got_s = tstream.stream_mttkrp(tc, tfs, cfg, exec_blocks=eb)
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5 * scale)
    # the quantized chain (within one ADC code of full scale of the jitted
    # reference) and the compiled fold (float reassociation) run too
    want_q = np.asarray(jstream.stream_mttkrp(jc, jfs, psram=True))
    got_q = tstream.stream_mttkrp(tc, tfs, psram=True)
    assert np.abs(got_q.numpy() - want_q).max() <= 2.0 ** -15 * np.abs(want_q).max()
    got_c = tstream.stream_mttkrp(tc, tfs, compiled=True)
    np.testing.assert_allclose(got_c.numpy(), want_s, rtol=1e-5, atol=1e-5 * scale)


def test_dense_paths_vs_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((7, 6, 5)).astype(np.float32)
    fs = _factors(x.shape, 4, seed=1)
    jfs, tfs = [jnp.asarray(f) for f in fs], [torch.tensor(f) for f in fs]
    xt = torch.tensor(x)
    np.testing.assert_array_equal(tm.khatri_rao(tfs[1:]).numpy(),
                                  np.asarray(jm.khatri_rao(jfs[1:])))
    for mode in range(3):
        np.testing.assert_array_equal(tm.matricize(xt, mode).numpy(),
                                      np.asarray(jm.matricize(jnp.asarray(x), mode)))
        want = np.asarray(jm.mttkrp_dense(jnp.asarray(x), jfs, mode))
        np.testing.assert_allclose(tm.mttkrp_dense(xt, tfs, mode).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tm.mttkrp_dense_kr(xt, tfs, mode).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
    ji, jv = jm.dense_to_coo(jnp.asarray(x))
    ti, tv = tm.dense_to_coo(xt)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    chain_j = jm.cp_chain_exact(ji, jv, tuple(jfs), 1)
    chain_t = tm.cp_chain_exact(ti, tv, tuple(tfs), 1)
    np.testing.assert_allclose(chain_t.numpy(), np.asarray(chain_j), rtol=1e-6, atol=0)


def test_device_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsynth.powerlaw_coo(0, (4, 4, 4), nnz=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.coo(np.zeros((1, 3), np.int32), np.zeros(1, np.float32), (4, 4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.factors([np.zeros((4, 2), np.float32)])


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_exact_sparse_mttkrp_equals_the_reference_segment_sum(mode):
    """The ordered fold (its plain version here): ``mttkrp_sparse`` on an
    unsorted COO with duplicate coordinates, and ``stream_mttkrp`` in steps
    small enough to split the head row's fiber across steps, are EQUAL to the
    reference's one global ``jax.ops.segment_sum`` path."""
    rng = np.random.default_rng(40 + mode)
    shape = (30, 24, 18)
    idx = rng.integers(0, shape, size=(2000, 3)).astype(np.int32)
    idx[:400, mode] = 3                                     # a long run, scattered
    rng.shuffle(idx)
    vals = rng.standard_normal(2000).astype(np.float32)
    fs = _factors(shape, 6, seed=mode)
    jfs, tfs = tuple(jnp.asarray(f) for f in fs), tuple(torch.tensor(f) for f in fs)
    want = np.asarray(jm.mttkrp_sparse(jnp.asarray(idx), jnp.asarray(vals), jfs, mode,
                                       shape[mode]))
    got = tm.mttkrp_sparse(torch.tensor(idx), torch.tensor(vals), tfs, mode, shape[mode])
    np.testing.assert_array_equal(got.numpy(), want)

    ref, port = _pair(seed_key=11, shape=(40, 30, 20), nnz=3000, alpha=1.6)
    jc, tc = jf.csf_for_mode(ref, mode), tf.csf_for_mode(port, mode)
    fs = _factors(ref.shape, 5, seed=mode + 3)
    jfs, tfs = tuple(jnp.asarray(f) for f in fs), tuple(torch.tensor(f) for f in fs)
    want_s = np.asarray(jstream.stream_mttkrp(jc, jfs))
    rows = 8
    assert tc.fiber_lengths().max() > 2 * rows, "no fiber spans a step"
    for eb in (None, 1, 3):
        got_s = tstream.stream_mttkrp(tc, tfs, PsramConfig(rows=rows), exec_blocks=eb)
        np.testing.assert_array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_chain_stream_runs_are_the_root_fibers(mode):
    """What the card's chain route is handed by ``stream_mttkrp``: one run
    per root fiber, tiling the stream, each inside one row's run; the
    non-target coordinates column by column; the longest fiber and each
    non-target mode's coordinate range. Kept on the CSF."""
    from repro_torch.kernels.ordered_fold import chain_coords

    _, port = _pair(seed_key=11, shape=(40, 30, 20), nnz=3000, alpha=1.6)
    csf = tf.csf_for_mode(port, mode)
    rid = csf.row_of_nonzero()
    idx = csf.expanded_indices()
    coords, seg_ptr, seg_rows, longest, ranges, _ = tstream._chain_stream(csf)
    assert seg_ptr.dtype == torch.int64 and seg_rows.dtype == torch.int64
    seg_ptr, seg_rows = seg_ptr.numpy(), seg_rows.numpy()
    starts = np.flatnonzero(np.r_[True, rid[1:] != rid[:-1]])
    np.testing.assert_array_equal(seg_ptr, np.r_[starts, csf.nnz])
    np.testing.assert_array_equal(seg_rows, rid[starts])
    assert longest == int(np.diff(seg_ptr).max())
    others = [d for d in range(3) if d != mode]
    assert coords.dtype == torch.int32 and coords.is_contiguous()
    assert torch.equal(coords, idx[:, others].int())
    assert torch.equal(chain_coords(idx.long(), mode), coords)
    assert ranges == {d: (int(idx[:, d].min()), int(idx[:, d].max())) for d in others}
    assert tstream._chain_stream(csf)[0] is coords                       # cached


def test_ordered_fold_plain_version_and_row_runs():
    """The plain version adds in stream order from the row's current value
    (chunked calls compose); ``row_runs`` gives each row's run of sorted ids."""
    from repro_torch.kernels.ordered_fold import ordered_fold, ordered_fold_torch, row_runs

    rng = np.random.default_rng(3)
    ids = torch.tensor(np.sort(rng.integers(0, 9, size=300)))
    d = torch.tensor(rng.standard_normal((300, 5)).astype(np.float32))
    start = torch.tensor(rng.standard_normal((11, 5)).astype(np.float32))
    whole = ordered_fold(start.clone(), d, ids)
    chunked = start.clone()
    for lo in range(0, 300, 70):
        ordered_fold(chunked, d[lo:lo + 70], ids[lo:lo + 70])
    assert torch.equal(whole, chunked)
    serial = start.clone()
    for i in range(300):
        serial[ids[i]] = serial[ids[i]] + d[i]
    assert torch.equal(whole, serial)
    assert torch.equal(ordered_fold_torch(start.clone(), d, ids), whole)
    ptr = row_runs(ids, 11)
    assert ptr.dtype == torch.int64 and ptr[0] == 0 and ptr[-1] == 300
    for r in range(11):
        assert (ids[ptr[r]:ptr[r + 1]] == r).all()
    with pytest.raises(ValueError, match="does not match"):
        ordered_fold(start.clone(), d[:, :4], ids)


def test_exact_sparse_mttkrp_keeps_its_sort_until_the_coo_is_written():
    """``mttkrp_sparse`` sorts a COO once per mode and keeps the sort with
    the indices; an in-place write to them makes it sort anew, and every
    result stays EQUAL to the reference's on the data it was given."""
    rng = np.random.default_rng(9)
    shape = (12, 10, 8)
    idx = rng.integers(0, shape, size=(500, 3)).astype(np.int32)
    vals = rng.standard_normal(500).astype(np.float32)
    fs = _factors(shape, 4, seed=2)
    jfs, tfs = tuple(jnp.asarray(f) for f in fs), tuple(torch.tensor(f) for f in fs)
    t_idx, t_vals = torch.tensor(idx), torch.tensor(vals)

    def want(i):
        return np.asarray(jm.mttkrp_sparse(jnp.asarray(i), jnp.asarray(vals), jfs, 1, shape[1]))

    first = tm.mttkrp_sparse(t_idx, t_vals, tfs, 1, shape[1])
    kept = tm._sorted_stream(t_idx, 1, shape[1])
    assert tm._sorted_stream(t_idx, 1, shape[1]) is kept
    np.testing.assert_array_equal(first.numpy(), want(idx))
    t_idx[:, 1] = torch.tensor(shape[1] - 1 - idx[:, 1])      # written in place
    assert tm._sorted_stream(t_idx, 1, shape[1]) is not kept
    again = tm.mttkrp_sparse(t_idx, t_vals, tfs, 1, shape[1])
    np.testing.assert_array_equal(again.numpy(), want(t_idx.numpy()))
