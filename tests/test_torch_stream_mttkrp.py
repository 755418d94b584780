"""The fused streaming MTTKRP of the port held against the JAX reference on
the CPU.

The port's plain version (what the wrapper uses for CPU tensors; what the
CUDA kernel is held against on the card) and its ``"ref"`` oracle are fed the
**reference's own** layout ``(ip, vp, lp, sp, n_seg)`` and quantized factors
``(qs, ss)`` through ``repro_torch.convert``, so only the fused arithmetic is
compared. The segment sums are f32 adds in an order each implementation
chooses, so results agree within float reassociation before the ADC and
within one ADC code of the chunk's full scale (``2·full_scale/2^bits``) after
it; an output row adds up to ``E`` blocks' worth of such partials per chunk,
hence the per-row tolerance below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.mttkrp import mttkrp_sparse as j_mttkrp_sparse
from repro.core.psram import PsramConfig as JPsramConfig
from repro.kernels import stream_mttkrp as jk
from repro.kernels.autotune import stream_params as j_stream_params
from repro.sparse import csf_for_mode as j_csf_for_mode
from repro.sparse import powerlaw_coo as j_powerlaw_coo
from repro.sparse.stream import stream_layout as j_stream_layout
from repro_torch import convert
from repro_torch.core.psram import PsramConfig
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stream_mttkrp as tk
from repro_torch.kernels.autotune import heuristic, stream_key, stream_params
from repro_torch.kernels.ops import fused_stream_mttkrp_op


def _reference_case(shape=(30, 24, 18), nnz=800, rank=6, mode=0, rows=256,
                    exec_blocks=None, seed_key=3, alpha=1.1):
    """A reference CSF, its factors (numpy seed), its layout and its codes."""
    coo = j_powerlaw_coo(jax.random.PRNGKey(seed_key), shape, nnz=nnz, rank=4,
                         alpha=alpha)
    csf = j_csf_for_mode(coo, mode)
    rng = np.random.default_rng(mode + 1)
    fs = tuple(jnp.asarray(rng.standard_normal((s, rank)).astype(np.float32))
               for s in shape)
    cfg = JPsramConfig(rows=rows)
    if exec_blocks is None:
        exec_blocks = j_stream_params(csf, fs, cfg)["exec_blocks"]
    ip, vp, lp, sp, n_seg = j_stream_layout(csf, rows, exec_blocks)
    qs, ss = jk.stream_factor_quants(fs, mode)
    return csf, fs, (ip, vp, lp, sp, n_seg), (qs, ss)


def _carry(layout, quants):
    lay = convert.layout(*[np.asarray(a) for a in layout[:4]], layout[4], device="cpu")
    qs, ss = convert.factor_quants([np.asarray(q) for q in quants[0]],
                                   [np.asarray(s) for s in quants[1]], device="cpu")
    return lay, qs, ss


def _row_tolerance(layout, adc_bits, parts_max, out_rows):
    """Per output row: one ADC code of the chunk's full scale for every
    (chunk, slot) that maps to the row."""
    sp = np.asarray(layout[3])                              # (nb, E*n_seg)
    lsb = 2.0 * np.maximum(parts_max, 1e-30) / 2 ** adc_bits if adc_bits \
        else np.zeros_like(parts_max)
    tol = np.zeros(out_rows + 1)
    np.add.at(tol, sp.reshape(-1), np.repeat(lsb, sp.shape[1]))
    return tol[:out_rows]


CASES = [
    dict(),                                                 # 3 modes, one chunk
    dict(rows=16, exec_blocks=4),                           # many chunks, ragged last block
    dict(rows=16, exec_blocks=1, mode=1),
    dict(rows=16, exec_blocks=3, mode=2),
    dict(shape=(9, 8, 7, 6), nnz=900, rank=5, mode=0, rows=32, exec_blocks=2, alpha=0.5),
    dict(shape=(9, 8, 7, 6), nnz=900, rank=5, mode=3, rows=32, exec_blocks=2, alpha=0.5),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()) or "default")
@pytest.mark.parametrize("adc_bits", [0, 16])
def test_plain_and_ref_vs_reference_lowerings(case, adc_bits):
    csf, fs, layout, quants = _reference_case(**case)
    mode = csf.mode_order[0]
    out_rows = csf.shape[mode]
    ip, vp, lp, sp, n_seg = layout
    qs, ss = quants
    want_xla = np.asarray(jk.stream_mttkrp_fused_xla(
        ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows))
    want_ref = np.asarray(jk.stream_mttkrp_fused_ref(
        ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows))
    lay, tqs, tss = _carry(layout, quants)
    args = (*lay[:4], tqs, tss, mode, n_seg, adc_bits, out_rows)
    got_plain, chunk_max = tk.stream_mttkrp_fused_torch(*args, return_chunk_max=True)
    got_ref = tref.stream_mttkrp_fused_ref(*args)
    got_wrapper = tk.stream_mttkrp_fused(*args)
    assert torch.equal(got_wrapper, got_plain)              # CPU tensors → plain version
    tol = _row_tolerance(layout, adc_bits, chunk_max.numpy(), out_rows)
    scale = np.abs(want_ref).max()
    for got in (got_plain.numpy(), got_ref.numpy()):
        for want in (want_xla, want_ref):
            bound = tol[:, None] + 1e-6 * np.abs(want) + 1e-6 * scale
            assert (np.abs(got - want) <= bound).all(), \
                float((np.abs(got - want) - bound).max())
    # and inside the documented envelope of the exact COO MTTKRP
    s = csf.to_coo()
    exact = np.asarray(j_mttkrp_sparse(s.indices, s.values, fs, mode, out_rows))
    rel = np.linalg.norm(got_plain.numpy() - exact) / np.linalg.norm(exact)
    assert rel < 0.05


def test_plain_version_vs_interpreted_pallas_kernel():
    """One small case through the reference's Pallas kernel body itself
    (interpret mode)."""
    csf, fs, layout, quants = _reference_case(nnz=300, rows=16, exec_blocks=4)
    ip, vp, lp, sp, n_seg = layout
    qs, ss = quants
    out_rows = csf.shape[0]
    want = np.asarray(jk.stream_mttkrp_fused_pallas(
        ip, vp, lp, sp, qs, ss, 0, n_seg, 16, out_rows, interpret=True))
    lay, tqs, tss = _carry(layout, quants)
    got, chunk_max = tk.stream_mttkrp_fused_torch(
        *lay[:4], tqs, tss, 0, n_seg, 16, out_rows, return_chunk_max=True)
    tol = _row_tolerance(layout, 16, chunk_max.numpy(), out_rows)
    bound = tol[:, None] + 1e-6 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got.numpy() - want) <= bound).all()


def test_quantized_factors_and_heuristic_match_reference():
    """The port's own store-side quantization gives the reference's codes
    (scales within one ulp of the jitted reference's), and both packages cut
    the same chunks when untuned."""
    csf, fs, _, (qs, ss) = _reference_case()
    tfs = tuple(torch.tensor(np.asarray(f)) for f in fs)
    tqs, tss = tk.quantize_stream_factors(tfs, 0)
    for d in (1, 2):
        assert tqs[d].dtype == torch.int8 and tuple(tss[d].shape) == (fs[d].shape[0], 1)
        np.testing.assert_array_equal(tqs[d].numpy(), np.asarray(qs[d]))
        np.testing.assert_allclose(tss[d].numpy(), np.asarray(ss[d]), rtol=2e-7, atol=0)
    assert tuple(tqs[0].shape) == (1, 1)
    tcsf = convert.csf(csf.shape, csf.mode_order, csf.fids, csf.fptr,
                       np.asarray(csf.values), device="cpu")
    for rows in (256, 16, 100):
        assert stream_params(tcsf, tfs, PsramConfig(rows=rows)) \
            == j_stream_params(csf, fs, JPsramConfig(rows=rows))
    key = stream_key(tcsf, 6, PsramConfig())
    assert key == stream_key(tcsf, 6, PsramConfig())          # by value
    assert heuristic(key) == {"exec_blocks": 32}
    from repro_torch.kernels import autotune as at

    at.clear_autotune_cache()                 # tune=True sweeps the candidates
    won = stream_params(tcsf, tfs, PsramConfig(), tune=True)
    assert won in at.candidates(key) and at.cache_stats() == (1, (key,))
    assert stream_params(tcsf, tfs, PsramConfig()) == won       # the winner, cached
    at.clear_autotune_cache()


def test_factor_quant_cache_is_identity_keyed():
    rng = np.random.default_rng(0)
    fs = tuple(torch.tensor(rng.standard_normal((s, 4)).astype(np.float32))
               for s in (5, 6, 7))
    first = tk.stream_factor_quants(fs, 1)
    assert tk.stream_factor_quants(fs, 1) is first           # same tensors: hit
    assert tk.stream_factor_quants(fs, 2) is not first       # other mode: miss
    rebuilt = (fs[0].clone(), fs[1], fs[2])                  # a sweep's new factor
    again = tk.stream_factor_quants(rebuilt, 1)
    assert again is not first
    assert torch.equal(again[0][0], first[0][0])


def test_op_end_to_end_on_port_inputs():
    """Float factors in, through the port's own layout and quantization:
    ``auto`` on CPU tensors is the plain version; inside the envelope of the
    reference's fused op on the same inputs (same layout, codes equal, scales
    within one ulp → within a few ADC codes) and of the exact result."""
    csf, fs, _, _ = _reference_case(rows=16, exec_blocks=4)
    tcsf = convert.csf(csf.shape, csf.mode_order, csf.fids, csf.fptr,
                       np.asarray(csf.values), device="cpu")
    tfs = tuple(torch.tensor(np.asarray(f)) for f in fs)
    cfg = PsramConfig(rows=16)
    got = {low: fused_stream_mttkrp_op(tcsf, tfs, cfg, lowering=low).numpy()
           for low in ("auto", "torch", "ref")}
    np.testing.assert_array_equal(got["auto"], got["torch"])
    from repro.kernels.ops import fused_stream_mttkrp_op as j_op
    want = np.asarray(j_op(csf, fs, JPsramConfig(rows=16), backend="xla"))
    for g in got.values():
        assert np.linalg.norm(g - want) / np.linalg.norm(want) < 1e-4
    with pytest.raises(ValueError, match="CUDA device"):
        fused_stream_mttkrp_op(tcsf, tfs, cfg, lowering="cuda")
    with pytest.raises(RuntimeError, match="lowering"):
        tk.fused_stream_mttkrp(tcsf, tfs, cfg, lowering="tpu-but-misspelled")


def test_segment_plan_of_the_cuda_kernel():
    """The kernel's compact addressing is index arithmetic on the layout,
    checkable without a card: every existing segment appears once, in stream
    order; each output row's run covers exactly the slots that map to it."""
    _, _, layout, quants = _reference_case(rows=16, exec_blocks=4)
    lay, _, _ = _carry(layout, quants)
    ip, vp, lp, sp, n_seg = lay
    out_rows = 30
    plan = tk.SegmentPlan.build(lp, sp, n_seg, out_rows)
    nb, e, _ = lp.shape
    nseg = lp[..., -1].reshape(-1).numpy() + 1
    assert plan.total == int(nseg.sum())
    np.testing.assert_array_equal(plan.seg_ptr.numpy(), np.concatenate(([0], np.cumsum(nseg))))
    sp2 = sp.numpy().reshape(nb * e, n_seg)
    seg_row = np.concatenate([sp2[b, :nseg[b]] for b in range(nb * e)])
    row_ptr = plan.row_ptr.numpy()
    for r in range(out_rows):
        assert (seg_row[row_ptr[r]:row_ptr[r + 1]] == r).all()
        assert (seg_row == r).sum() == row_ptr[r + 1] - row_ptr[r]
    np.testing.assert_array_equal(
        plan.seg_chunk.numpy(), np.repeat(np.arange(nb * e) // e, nseg))
    # slots the layout pads with map to the sacrificial row only
    assert (sp2[np.arange(n_seg)[None, :] >= nseg[:, None]] == out_rows).all()
    bad = lp.clone()
    bad[0, 0, 3] = 5
    with pytest.raises(ValueError, match="sorted block layout"):
        tk.SegmentPlan.build(bad, sp, n_seg, out_rows)


def test_wrapper_rejects_malformed_layouts():
    _, _, layout, quants = _reference_case(rows=16, exec_blocks=4)
    lay, qs, ss = _carry(layout, quants)
    ip, vp, lp, sp, n_seg = lay
    with pytest.raises(TypeError):
        tk.stream_mttkrp_fused(ip.long(), vp, lp, sp, qs, ss, 0, n_seg, 16, 30)
    with pytest.raises(ValueError):
        tk.stream_mttkrp_fused(ip, vp[:-1], lp, sp, qs, ss, 0, n_seg, 16, 30)
    with pytest.raises(ValueError):
        tk.stream_mttkrp_fused(ip, vp, lp, sp, qs, ss, 5, n_seg, 16, 30)
    before = tk.stream_mttkrp_fused.launches
    tk.stream_mttkrp_fused(ip, vp, lp, sp, qs, ss, 0, n_seg, 16, 30)
    assert tk.stream_mttkrp_fused.launches == before         # CPU: no launch


def chunk_smem(rank, nmodes, chunk_segs):
    """A chunk-route CTA's shared memory as the library lays it out: 8 warps
    x (3 slots of 32 nonzeros' factor rows and scales, 5 slots of their
    coordinates, values, segment ids and scales; 2 and 3 at rank 128), 16
    warp maxima and the chunk's partials (the card's ``_chunk_smem`` is held
    to it in ``test_torch_cuda_kernels.py``)."""
    k = nmodes - 1
    rows_slots, meta_slots = (2, 3) if rank == 128 else (3, 5)
    ring = 8 * (rows_slots * (32 * k * rank + 32 * k * 4)
                + meta_slots * (32 * nmodes * 4 + 3 * 32 * 4)) + 16 * 4
    return ring + 4 * chunk_segs * rank


@pytest.mark.parametrize("rank,nmodes,chunk_segs,aligned,route", [
    (32, 3, 40, True, "chunk"),          # the main path: rank 32, ~40 segments a chunk
    (16, 3, 40, True, "chunk"),
    (64, 3, 40, True, "chunk"),
    (128, 3, 40, True, "chunk"),
    (32, 2, 1, True, "chunk"),
    (32, 6, 40, True, "chunk"),          # five non-target factors: the f32 chain
    (40, 4, 40, True, "three_pass"),     # factor rows not a multiple of 16 bytes
    (48, 3, 40, True, "three_pass"),     # 16-byte rows, but not a rank the kernel is built for
    (6, 3, 4, True, "three_pass"),
    (144, 3, 4, True, "three_pass"),     # wider than the adding lanes cover
    (32, 3, 40, False, "three_pass"),    # codes not on 16 bytes
    (64, 3, 2645, True, "three_pass"),   # the chunk's partials overflow shared memory
    (128, 8, 1, True, "three_pass"),     # the gather ring alone overflows it
])
def test_route_rule(rank, nmodes, chunk_segs, aligned, route):
    """Kernel 1's route from shape, alignment and the chunk's shared-memory
    fit alone."""
    smem = chunk_smem(rank, nmodes, chunk_segs)
    assert tk._route(rank, smem, aligned) == route
    assert tk._chunk_takes(rank, smem, aligned) == (route == "chunk")


@pytest.mark.parametrize("rank,nmodes", [(32, 3), (16, 2), (64, 5), (128, 3)])
def test_route_rule_shared_memory_edge(rank, nmodes):
    """The route flips where a CTA passes the 227 KB it may opt in to."""
    fit = (tk.MAX_SMEM - chunk_smem(rank, nmodes, 0)) // (4 * rank)
    assert tk._route(rank, chunk_smem(rank, nmodes, fit), True) == "chunk"
    assert tk._route(rank, chunk_smem(rank, nmodes, fit + 1), True) == "three_pass"
    assert tk._route(rank, tk.MAX_SMEM, True) == "chunk"
    assert tk._route(rank, tk.MAX_SMEM + 1, True) == "three_pass"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()) or "default")
def test_segment_plan_chunk_segs(case):
    """The plan's ``chunk_segs`` (what sizes a chunk-route CTA) is the most
    segments one chunk of ``E`` blocks holds, recomputed here from ``lp``."""
    csf, _, layout, quants = _reference_case(**case)
    lay, _, _ = _carry(layout, quants)
    ip, vp, lp, sp, n_seg = lay
    plan = tk.SegmentPlan.build(lp, sp, n_seg, csf.shape[csf.mode_order[0]])
    per_chunk = (lp.numpy()[..., -1].astype(np.int64) + 1).sum(axis=1)     # (nb,)
    assert plan.chunk_segs == int(per_chunk.max())
    assert plan.total == int(per_chunk.sum())
    np.testing.assert_array_equal(plan.seg_ptr.numpy()[::lp.shape[1]],
                                  np.concatenate(([0], np.cumsum(per_chunk))))
    assert plan.long_rows.numel() == 0                      # no run of 257 segments here


@pytest.mark.parametrize("rows", [8, 16, 64])
def test_segment_plan_long_rows(rows):
    """The rows the fold gives a CTA of their own: every row whose run holds
    more than ``LONG_RUN`` segments, recomputed here from ``(lp, sp)``."""
    from repro_torch.sparse import csf_for_mode, powerlaw_coo, stream_layout
    coo = powerlaw_coo(5, (40, 3000, 200), nnz=100_000, rank=4, alpha=1.6, device="cpu")
    ip, vp, lp, sp, n_seg = stream_layout(csf_for_mode(coo, 0), rows, 32)
    plan = tk.SegmentPlan.build(lp, sp, n_seg, 40)
    nseg = lp.numpy()[..., -1].reshape(-1).astype(np.int64) + 1
    seg_row = np.concatenate([sp.numpy().reshape(-1, n_seg)[b, :nseg[b]]
                              for b in range(len(nseg))])
    runs = np.bincount(seg_row, minlength=41)[:40]
    want = np.flatnonzero(runs > tk.LONG_RUN)
    assert len(want) > 0                                   # the fixture has long runs
    np.testing.assert_array_equal(plan.long_rows.numpy(), want)
    assert plan.long_run == tk.LONG_RUN                    # the fold's warps skip these runs
    assert plan.long_rows.dtype == torch.int32


def test_launch_refuses_cpu_tensors_and_unknown_routes():
    _, _, layout, quants = _reference_case(rows=16, exec_blocks=4)
    lay, qs, ss = _carry(layout, quants)
    ip, vp, lp, sp, n_seg = lay
    args = (ip, vp, lp, sp, qs, ss, 0, n_seg, 16, 30)
    with pytest.raises(ValueError, match="route must be one of"):
        tk._launch(*args, route="fast")
    for route in (None, *tk.ROUTES):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            tk._launch(*args, route=route)
    assert tk.ROUTES == tuple(tk.stream_mttkrp_fused.routes)
