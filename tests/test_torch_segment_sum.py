"""The blocked segment sum of the port, and the ``compiled=False`` sparse path
that runs it, held against the JAX reference on the CPU.

Kernel level: the port's plain version (what the wrapper uses for CPU tensors;
what the CUDA kernel is held against on the card) and its ``"ref"`` oracle
against the reference's Pallas kernel in interpret mode and its oracle, on
blocks made from a numpy seed and carried across with ``convert``: within
1e-6 of the summed magnitudes of each slot (the one-hot contraction and the
ordered adds sum in other orders).
The plain version on the CPU adds every row in order, which is what lets the
CUDA kernel be held bit-equal to it on the card; that order is checked here
against a sequential f32 fold.

Slice level: ``backends.get("hopper", compiled=False)`` on a power-law CSF
against the reference's legacy ``"pallas"`` backend (exact chain, ~1e-5
reassociation envelope), and CP-ALS on it from the reference's initial
factors against the reference's CP-ALS on the same backend: fit within 1e-4.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import backends as jbackends
from repro.kernels import ref as jref
from repro.kernels.segment_sum import blocked_segment_sum as j_blocked_segment_sum
from repro.sparse import csf_for_mode as j_csf_for_mode
from repro.sparse import powerlaw_coo as j_powerlaw_coo
from repro.sparse.stream import _block_segments as j_block_segments
from repro_torch import backends, convert
from repro_torch.core import cp_als as t_cp
from repro_torch.core.psram import PsramConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_sum as tk
from repro_torch.sparse import csf_for_mode, stream_mttkrp, stream_mttkrp_blocked

j_cp = importlib.import_module("repro.core.cp_als")   # the module, not the function


def _blocks(b, bn, r, n_seg, seed, sorted_ids):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((b, bn, r)).astype(np.float32)
    ids = rng.integers(0, n_seg, size=(b, bn)).astype(np.int32)
    if sorted_ids:
        ids.sort(axis=1)
    return data, ids


CASES = [
    dict(b=3, bn=16, r=8, n_seg=5, sorted_ids=True),
    dict(b=2, bn=64, r=40, n_seg=64, sorted_ids=False),   # rank over one 32-column tile
    dict(b=5, bn=7, r=3, n_seg=9, sorted_ids=False),      # more slots than rows
    dict(b=1, bn=256, r=32, n_seg=1, sorted_ids=True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_plain_and_ref_vs_interpreted_pallas_kernel(case):
    data, ids = _blocks(case["b"], case["bn"], case["r"], case["n_seg"], 7, case["sorted_ids"])
    n_seg = case["n_seg"]
    want = np.asarray(j_blocked_segment_sum(jnp.asarray(data), jnp.asarray(ids), n_seg,
                                            interpret=True))
    want_ref = np.asarray(jref.blocked_segment_sum_ref(jnp.asarray(data), jnp.asarray(ids), n_seg))
    tdata, tids = convert.segment_blocks(data, ids, device="cpu")
    assert tdata.dtype == torch.float32 and tids.dtype == torch.int32
    plain = tk.blocked_segment_sum_torch(tdata, tids, n_seg)
    before = tk.blocked_segment_sum.launches
    assert torch.equal(tk.blocked_segment_sum(tdata, tids, n_seg), plain)   # CPU → plain
    assert tk.blocked_segment_sum.launches == before
    oracle = tref.blocked_segment_sum_ref(tdata, tids, n_seg)
    assert tuple(plain.shape) == (case["b"], n_seg, case["r"])
    # 1e-6 of the sum of the magnitudes added into each slot
    mag = tk.blocked_segment_sum_torch(tdata.abs(), tids, n_seg).numpy()
    for got in (plain.numpy(), oracle.numpy()):
        for w in (want, want_ref):
            assert (np.abs(got - w) <= 1e-6 * mag).all()


def test_plain_version_adds_rows_in_order():
    """The CPU plain version is the sequential f32 fold in row order, bit for
    bit — the order the CUDA kernel adds in."""
    data, ids = _blocks(4, 50, 6, 7, 3, sorted_ids=False)
    got = tk.blocked_segment_sum_torch(*convert.segment_blocks(data, ids, device="cpu"), 7)
    want = np.zeros((4, 7, 6), np.float32)
    for b in range(4):
        for p in range(50):
            want[b, ids[b, p]] = want[b, ids[b, p]] + data[b, p]
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_and_op_errors():
    data, ids = convert.segment_blocks(*_blocks(2, 8, 4, 3, 1, True), device="cpu")
    with pytest.raises(ValueError, match="seg_ids"):
        tk.blocked_segment_sum(data, ids[:, :-1], 3)
    with pytest.raises(TypeError):
        tk.blocked_segment_sum(data, ids.long(), 3)
    with pytest.raises(ValueError, match="n_seg"):
        tk.blocked_segment_sum(data, ids, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        tops.blocked_segment_sum_op(data, ids, 3, lowering="cuda")
    for low in ("auto", "torch", "ref"):
        np.testing.assert_allclose(tops.blocked_segment_sum_op(data, ids, 3, lowering=low).numpy(),
                                   tk.blocked_segment_sum_torch(data, ids, 3).numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert tk.MAX_SEGMENTS == 1816


# ------------------------------------------------------------- slice level


@pytest.fixture(scope="module")
def reference_tensor():
    coo = j_powerlaw_coo(jax.random.PRNGKey(4), (40, 30, 20), nnz=1500, rank=3, alpha=1.1)
    fs = [np.random.default_rng(30 + d).standard_normal((s, 6)).astype(np.float32)
          for d, s in enumerate(coo.shape)]
    return coo, fs


def _port_csf(csf):
    return convert.csf(csf.shape, csf.mode_order, csf.fids, csf.fptr,
                       np.asarray(csf.values), device="cpu")


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("rows", [256, 16])
def test_hopper_legacy_sparse_vs_reference_pallas(mode, rows, reference_tensor):
    coo, fs = reference_tensor
    csf = j_csf_for_mode(coo, mode)
    from repro.core.psram import PsramConfig as JPsramConfig
    want = np.asarray(jbackends.get("pallas", JPsramConfig(rows=rows), compiled=False,
                                    lowering="interpret").mttkrp(
        csf, tuple(jnp.asarray(f) for f in fs), mode))
    # the block structure is the reference's, array for array
    tcsf = _port_csf(csf)
    from repro_torch.sparse.stream import _block_segments
    for a, b in zip(_block_segments(tcsf, rows), j_block_segments(csf, rows)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tfs = tuple(convert.factors(fs, device="cpu"))
    got = backends.get("hopper", PsramConfig(rows=rows), compiled=False).mttkrp(tcsf, tfs, mode)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
    # the same schedule as the exact eager stream, reassociated
    eager = stream_mttkrp(tcsf, tfs, PsramConfig(rows=rows)).numpy()
    np.testing.assert_allclose(got.numpy(), eager, rtol=1e-5, atol=1e-5 * scale)
    for low in ("torch", "ref"):
        np.testing.assert_allclose(
            stream_mttkrp_blocked(tcsf, tfs, PsramConfig(rows=rows), lowering=low).numpy(),
            got.numpy(), rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("rows", [256, 16])
def test_blocked_fold_bit_equal_to_the_index_add_order(mode, rows, reference_tensor):
    """The partials folded in the cached stable order of their rows give the
    bits of the earlier scatter: every ``(B, n_seg)`` partial added with one
    ``index_add_`` into ``out_rows + 1`` rows (the CPU adds in stream order),
    the sacrificial row dropped."""
    coo, fs = reference_tensor
    tcsf = _port_csf(j_csf_for_mode(coo, mode))
    tfs = tuple(convert.factors(fs, device="cpu"))
    cfg = PsramConfig(rows=rows)
    from repro_torch.core.mttkrp import cp_chain_exact
    from repro_torch.sparse.stream import _block_segments

    local, seg_rows, n_seg = _block_segments(tcsf, rows)
    local, seg_rows = torch.as_tensor(local), torch.as_tensor(seg_rows.reshape(-1))
    # the padded stream the earlier path formed the chain over
    idx, vals = tcsf.expanded_indices_np(), tcsf.values.numpy()
    pad = local.numel() - len(vals)
    ip = torch.as_tensor(np.pad(idx, ((0, pad), (0, 0))).reshape(*local.shape, -1))
    vp = torch.as_tensor(np.pad(vals, (0, pad)).reshape(local.shape))
    partials = tk.blocked_segment_sum_torch(cp_chain_exact(ip, vp, tfs, mode), local, n_seg)
    out_rows = coo.shape[mode]
    want = torch.zeros((out_rows + 1, 6)).index_add_(0, seg_rows, partials.reshape(-1, 6))
    for low in ("auto", "torch", "ref"):
        got = stream_mttkrp_blocked(tcsf, tfs, cfg, lowering=low)
        assert got.shape == (out_rows, 6)
        assert torch.equal(got, want[:out_rows])


@pytest.mark.parametrize("rows", [256, 16, 7])
def test_blocked_fold_order_is_stable_and_drops_only_sacrificial_slots(rows, reference_tensor):
    coo, _ = reference_tensor
    tcsf = _port_csf(j_csf_for_mode(coo, 1))
    from repro_torch.kernels.ordered_fold import row_runs
    from repro_torch.sparse.stream import _block_segments, _segment_blocks

    cached = _segment_blocks(tcsf, rows)
    assert _segment_blocks(tcsf, rows) is cached                 # cached on the CSF
    order, fold_rows, fold_runs = (t.numpy() for t in cached[2:5])
    flat = _block_segments(tcsf, rows)[1].reshape(-1)
    out_rows = coo.shape[1]
    # exactly the slots of real rows, each once
    np.testing.assert_array_equal(np.sort(order), np.flatnonzero(flat != out_rows))
    np.testing.assert_array_equal(fold_rows, flat[order])
    assert (np.diff(fold_rows) >= 0).all()
    # stable: a row's slots keep their (block, segment) order
    same = np.diff(fold_rows) == 0
    assert (np.diff(order)[same] > 0).all()
    np.testing.assert_array_equal(
        fold_runs, row_runs(torch.as_tensor(fold_rows), out_rows).numpy())


def test_hopper_legacy_on_any_data_form(reference_tensor):
    """A COO triple and a CSF rooted elsewhere are sorted into the mode's CSF
    first, as on the fused path."""
    coo, fs = reference_tensor
    t = convert.coo(np.asarray(coo.indices), np.asarray(coo.values), coo.shape, device="cpu")
    tfs = tuple(convert.factors(fs, device="cpu"))
    be = backends.get("hopper", compiled=False)
    want = be.mttkrp(csf_for_mode(t, 1), tfs, 1)
    for data in (t, (t.indices, t.values, t.shape), csf_for_mode(t, 0)):
        np.testing.assert_array_equal(be.mttkrp(data, tfs, 1).numpy(), want.numpy())


@pytest.mark.parametrize("n_iter", [3])
def test_cp_als_legacy_reaches_the_reference_fit(n_iter, reference_tensor):
    """Both packages start from the reference's ``jax.random`` factors and run
    the same sweeps on the legacy per-op path: fits within 1e-4."""
    coo, _ = reference_tensor
    rank = 4
    key = jax.random.PRNGKey(13)
    init = [np.asarray(f) for f in j_cp.init_factors(key, coo.shape, rank)]
    ref = j_cp.cp_als(None, rank, n_iter=n_iter, key=key, sparse=coo,
                      backend=jbackends.get("pallas", compiled=False), tol=0)
    t_coo = convert.coo(np.asarray(coo.indices), np.asarray(coo.values), coo.shape,
                        mode_order=coo.mode_order, device="cpu")
    got = t_cp.cp_als(None, rank, n_iter=n_iter, sparse=t_coo,
                      backend=backends.get("hopper", compiled=False),
                      init=convert.factors(init, device="cpu"), tol=0)
    assert got.iters == ref.iters == n_iter
    assert abs(got.fit - ref.fit) < 1e-4
