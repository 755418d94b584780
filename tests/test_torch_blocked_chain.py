"""The blocked segment sum's chain route — the exact chain formed inside the
segment sum — held on the CPU against the composition it replaces and the
JAX reference.

Kernel level: the chain route's plain version (what the CUDA kernel is held
against on the card) is bit-equal to the composition the ``compiled=False``
path ran before it, ``cp_chain_exact`` over the padded stream, then the
rows route's plain version; and it adds each slot's rows in row order from
0.0, the padding adding nothing. Slice level: ``stream_mttkrp_blocked``
under every lowering is bit-equal to that composition followed by one
``index_add_`` of the partials, and within rtol 1e-5 of the reference's
``stream_mttkrp_blocked`` (whose blocked segment sum is a matrix product
that reassociates); a coordinate outside its factor raises ``IndexError``
before anything runs; and the CSF's cache holds what the route reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.psram import PsramConfig as JPsramConfig
from repro.sparse import csf_for_mode as j_csf_for_mode
from repro.sparse import powerlaw_coo as j_powerlaw_coo
from repro.sparse.stream import stream_mttkrp_blocked as j_stream_mttkrp_blocked
from repro_torch import convert
from repro_torch.core.mttkrp import cp_chain_exact
from repro_torch.core.psram import PsramConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_sum as tk
from repro_torch.kernels.ordered_fold import chain_coords
from repro_torch.sparse.stream import (_block_segments, _chain_stream, _segment_blocks,
                                       stream_mttkrp_blocked)

SHAPES = {3: (40, 30, 20), 4: (14, 11, 9, 8)}


@pytest.fixture(scope="module")
def tensors():
    """One seeded reference tensor of 3 and one of 4 modes, with numpy factors
    at every rank the cases use."""
    out = {}
    for nmodes, shape in SHAPES.items():
        coo = j_powerlaw_coo(jax.random.PRNGKey(20 + nmodes), shape, nnz=1500, rank=3,
                             alpha=1.1)
        fs = {r: [np.random.default_rng(40 + 7 * d + r).standard_normal((s, r))
                  .astype(np.float32) for d, s in enumerate(shape)] for r in (6, 32, 40)}
        out[nmodes] = (coo, fs)
    return out


def _port_csf(csf):
    return convert.csf(csf.shape, csf.mode_order, csf.fids, csf.fptr,
                       np.asarray(csf.values), device="cpu")


def _case(tensors, nmodes, mode, rank):
    coo, fs = tensors[nmodes]
    return _port_csf(j_csf_for_mode(coo, mode)), tuple(convert.factors(fs[rank], device="cpu"))


def _padded_composition(csf, factors, rows):
    """The earlier ``compiled=False`` path's partials: the CSF's full
    coordinates and values padded with zeros to whole blocks (numpy),
    ``cp_chain_exact`` over them, the rows route's plain version."""
    mode = csf.mode_order[0]
    local, _, n_seg = _block_segments(csf, rows)
    idx, vals = csf.expanded_indices_np(), csf.values.numpy()
    pad = local.size - len(vals)
    ip = torch.as_tensor(np.pad(idx, ((0, pad), (0, 0))).reshape(*local.shape, -1))
    vp = torch.as_tensor(np.pad(vals, (0, pad)).reshape(local.shape))
    d = cp_chain_exact(ip, vp, factors, mode)
    return tk.blocked_segment_sum_torch(d, torch.as_tensor(local), n_seg), n_seg


PLAIN_CASES = (
    [(3, mode, rows, 6) for mode in range(3) for rows in (256, 16, 7)]
    + [(4, mode, 16, 6) for mode in (0, 3)] + [(4, 1, 7, 32)]
    + [(3, 1, 16, 32), (3, 2, 7, 40), (3, 0, 256, 40)]
)


@pytest.mark.parametrize("nmodes,mode,rows,rank", PLAIN_CASES,
                         ids=lambda v: str(v))
def test_plain_version_bit_equal_to_the_padded_composition(tensors, nmodes, mode, rows, rank):
    csf, fs = _case(tensors, nmodes, mode, rank)
    want, n_seg = _padded_composition(csf, fs, rows)
    local = _segment_blocks(csf, rows)[0]
    coords = _chain_stream(csf)[0]
    got = tk.blocked_chain_segment_sum_torch(coords, csf.values, local, fs, mode, n_seg)
    assert got.shape == (local.shape[0], n_seg, rank)
    assert torch.equal(got, want)
    for low in ("auto", "torch"):
        assert torch.equal(tops.blocked_chain_segment_sum_op(coords, csf.values, local, fs, mode,
                                                             n_seg, lowering=low), want)


def test_plain_version_sums_in_row_order_and_skips_the_padding():
    """Each slot is the f32 sum from 0.0, in row order, of its positions'
    ``v · (F_a ⊙ F_b)`` (numpy, one rounding an operation); positions past
    ``nnz`` and slots no position maps to stay 0.0, whatever ids the padding
    carries; ids need not be sorted."""
    rng = np.random.default_rng(5)
    shape, rank, nnz, b, bn, n_seg = (9, 7, 5), 5, 45, 4, 13, 6
    coords = np.stack([rng.integers(0, shape[d], nnz) for d in (0, 2)], 1).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[::7] = 0.0
    ids = rng.integers(0, n_seg - 1, (b, bn)).astype(np.int32)     # slot n_seg - 1 unused
    fs = [rng.standard_normal((s, rank)).astype(np.float32) for s in shape]
    want = np.zeros((b, n_seg, rank), np.float32)
    for p in range(nnz):
        blk, j = divmod(p, bn)
        d = vals[p] * (fs[0][coords[p, 0]] * fs[2][coords[p, 1]])
        want[blk, ids[blk, j]] = want[blk, ids[blk, j]] + d
    got = tk.blocked_chain_segment_sum_torch(
        torch.as_tensor(coords), torch.as_tensor(vals), torch.as_tensor(ids),
        tuple(map(torch.as_tensor, fs)), 1, n_seg)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nmodes,mode,rows", [(3, 0, 256), (3, 1, 16), (3, 2, 7),
                                              (4, 0, 16), (4, 3, 7)])
def test_blocked_path_bit_equal_to_the_earlier_composition(tensors, nmodes, mode, rows):
    """``stream_mttkrp_blocked`` under every lowering: the earlier path's
    partials added with one ``index_add_`` into ``out_rows + 1`` rows (the
    CPU adds in stream order), the sacrificial row dropped — the same bits."""
    csf, fs = _case(tensors, nmodes, mode, 6)
    partials, _ = _padded_composition(csf, fs, rows)
    seg_rows = torch.as_tensor(_block_segments(csf, rows)[1].reshape(-1))
    out_rows = csf.shape[mode]
    want = torch.zeros((out_rows + 1, 6)).index_add_(0, seg_rows, partials.reshape(-1, 6))
    for low in ("auto", "torch", "ref"):
        got = stream_mttkrp_blocked(csf, fs, PsramConfig(rows=rows), lowering=low)
        assert torch.equal(got, want[:out_rows]), low


@pytest.mark.parametrize("nmodes,mode,rows", [(3, 0, 256), (3, 2, 16), (4, 1, 16)])
def test_blocked_path_within_the_reference(tensors, nmodes, mode, rows):
    """Against the reference's ``stream_mttkrp_blocked`` (its Pallas kernel
    interpreted) on the same seeded tensor and factors: rtol 1e-5, the
    reassociation envelope of a one-hot matrix product."""
    coo, fs = tensors[nmodes]
    csf = j_csf_for_mode(coo, mode)
    want = np.asarray(j_stream_mttkrp_blocked(csf, tuple(jnp.asarray(f) for f in fs[32]),
                                              JPsramConfig(rows=rows), backend="interpret"))
    tfs = tuple(convert.factors(fs[32], device="cpu"))
    got = stream_mttkrp_blocked(_port_csf(csf), tfs, PsramConfig(rows=rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_op_dispatch_and_the_wrappers_refusals(tensors):
    csf, fs = _case(tensors, 3, 1, 6)
    local, n_seg = _segment_blocks(csf, 16)[:2]
    coords = _chain_stream(csf)[0]
    args = (coords, csf.values, local, fs, 1, n_seg)
    before = (tk.blocked_segment_sum.launches, dict(tk.blocked_segment_sum.routes))
    with pytest.raises(ValueError, match="CUDA device"):
        tops.blocked_chain_segment_sum_op(*args, lowering="cuda")
    with pytest.raises(ValueError, match="unknown kernel lowering"):
        tops.blocked_chain_segment_sum_op(*args, lowering="xla")
    with pytest.raises(ValueError, match="CUDA tensors"):       # the wrapper itself
        tk.blocked_chain_segment_sum(*args)
    assert (tk.blocked_segment_sum.launches, tk.blocked_segment_sum.routes) == before
    plain = tk.blocked_chain_segment_sum_torch(*args)
    assert torch.equal(tops.blocked_chain_segment_sum_op(*args), plain)     # auto → torch
    ref = tops.blocked_chain_segment_sum_op(*args, lowering="ref")
    np.testing.assert_allclose(ref.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="do not fit"):
        tk.blocked_chain_segment_sum_torch(coords, csf.values, local[:1], fs, 1, n_seg)
    with pytest.raises(ValueError, match="does not match"):
        tk.blocked_chain_segment_sum_torch(coords[:, :1], csf.values, local, fs, 1, n_seg)
    with pytest.raises(TypeError):
        tk.blocked_chain_segment_sum_torch(coords, csf.values, local.long(), fs, 1, n_seg)
    with pytest.raises(ValueError, match="n_seg"):
        tk.blocked_chain_segment_sum_torch(coords, csf.values, local, fs, 1, 0)


@pytest.mark.parametrize("low", ["auto", "torch", "ref"])
def test_out_of_range_coordinates_raise(tensors, low):
    """A factor shorter than its mode's coordinates: ``IndexError`` naming
    the mode, before any kernel or plain version runs."""
    csf, fs = _case(tensors, 3, 0, 6)
    short = fs[:2] + (fs[2][:5],)
    before = dict(tk.blocked_segment_sum.routes)
    with pytest.raises(IndexError, match="mode 2"):
        stream_mttkrp_blocked(csf, short, PsramConfig(rows=16), lowering=low)
    assert tk.blocked_segment_sum.routes == before


@pytest.mark.parametrize("rows", [256, 16, 7])
def test_cpu_cache_holds_what_the_route_reads(tensors, rows):
    """The CSF caches the route's operands once: the block-local ids
    ``(B, rows)`` int32, non-decreasing within each block (the kernel's fast
    case) and in ``[0, n_seg)``, and the non-target coordinates ``(nnz,
    nmodes - 1)`` int32 (``chain_coords``); no padded stream is kept."""
    csf, fs = _case(tensors, 3, 2, 6)
    cached = _segment_blocks(csf, rows)
    assert len(cached) == 6
    stream_mttkrp_blocked(csf, fs, PsramConfig(rows=rows))
    assert _segment_blocks(csf, rows) is cached
    local, n_seg = cached[:2]
    assert local.dtype == torch.int32 and local.is_contiguous()
    assert local.shape == (-(-csf.nnz // rows), rows)
    assert (local.diff(dim=1) >= 0).all() and int(local.min()) >= 0 and int(local.max()) < n_seg
    coords = _chain_stream(csf)[0]
    assert _chain_stream(csf)[0] is coords
    assert coords.dtype == torch.int32 and coords.is_contiguous()
    assert torch.equal(coords, chain_coords(csf.expanded_indices(), 2))
    kept = [v for v in csf.__dict__.values() if isinstance(v, tuple)]
    assert not any(isinstance(t, torch.Tensor) and t.ndim == 3
                   for entry in kept for t in entry)
