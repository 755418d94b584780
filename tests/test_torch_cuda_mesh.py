"""The mesh executor and the autotune sweep on a card.

Each lowering of ``sparse.mesh.mesh_stream_mttkrp`` at 1 and 4 arrays on the
card (the shards looped on one device) against the same call on the CPU (the
kernels' plain versions), the eager lowering bit-equal to the single-device
stream on the card, the launches each lowering makes, and a tuned ``hopper``
backend bit-equal to the untuned call at the winner's ``exec_blocks``.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
source at first use); they carry the ``cuda`` marker and skip elsewhere. Run
them on the GPU machine with

    python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py

They import nothing of the JAX reference package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import backends
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ordered_fold as of
from repro_torch.kernels import segment_sum as ss
from repro_torch.kernels import stream_mttkrp as sm
from repro_torch.kernels.ops import fused_stream_mttkrp_op
from repro_torch.launch.mesh import make_array_mesh
from repro_torch.sparse import (MESH_LOWERINGS, csf_for_mode, mesh_gram, mesh_stream_mttkrp,
                                powerlaw_coo, stream_mttkrp)
from repro_torch.sparse import stream as tstream

pytestmark = pytest.mark.cuda

SHAPE, RANK = (300, 200, 100), 32


@pytest.fixture
def card():
    """Decided when the test runs, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(device, mode):
    coo = powerlaw_coo(5, SHAPE, nnz=60000, rank=4, alpha=1.6, device=device)
    rng = np.random.default_rng(mode)
    fs = tuple(torch.tensor(rng.standard_normal((s, RANK)).astype(np.float32), device=device)
               for s in SHAPE)
    return coo, csf_for_mode(coo, mode), fs


def _launches():
    torch.cuda.synchronize()
    return (sm.stream_mttkrp_fused.launches, ss.blocked_segment_sum.routes["chain_psram"],
            of.ordered_fold.routes["chain_psram"], of.ordered_fold.routes["fold"])


@pytest.mark.parametrize("n_arrays", [1, 4])
@pytest.mark.parametrize("lowering", MESH_LOWERINGS)
@pytest.mark.parametrize("mode", [0, 2])
def test_each_lowering_on_the_card_against_its_plain_version(card, lowering, n_arrays, mode):
    """The card's result equal to the same call on the CPU — bit for bit
    for the eager and compiled lowerings (both fold in order), within 8
    codes of a 16-bit ADC at the output's full scale for the fused one — and
    one launch (two, compiled) a non-empty shard on the route the lowering
    names; the eager lowering bit-equal to the single-device stream."""
    _, csf, fs = _case(card, mode)
    _, csf_cpu, fs_cpu = _case("cpu", mode)
    before = _launches()
    got = mesh_stream_mttkrp(csf, fs, n_arrays=n_arrays, lowering=lowering)
    after = _launches()
    assert got.is_cuda and bool(torch.isfinite(got).all())
    shards = sum(1 for s in _partition(csf, n_arrays).shards if s.nnz)
    made = [b - a for a, b in zip(before, after)]
    want_made = {"eager": [0, 0, shards, 0], "compiled": [0, shards, 0, shards],
                 "fused": [shards, 0, 0, 0]}[lowering]
    assert made == want_made
    want = mesh_stream_mttkrp(csf_cpu, fs_cpu, n_arrays=n_arrays, lowering=lowering)
    if lowering == "fused":
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 2.0 ** -15 * scale * 8
    else:
        assert torch.equal(got.cpu(), want)
    if lowering == "eager":
        assert torch.equal(got, stream_mttkrp(csf, fs, psram=True))
    np.testing.assert_allclose(mesh_gram(fs[0], n_arrays=n_arrays).cpu().numpy(),
                               (fs_cpu[0].T @ fs_cpu[0]).numpy(), rtol=1e-5, atol=1e-4)


def _partition(csf, n_arrays):
    from repro_torch.backends import resolve_config
    from repro_torch.sparse.mesh import _mesh_partition

    return _mesh_partition(csf, n_arrays, RANK, resolve_config(None), "makespan")


def test_the_array_mesh_spans_the_visible_cards(card):
    mesh = make_array_mesh()
    assert mesh.n_arrays == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in mesh.devices)
    four = make_array_mesh(4)
    assert four.n_arrays == 4 and {four.device_of(a) for a in range(4)} <= set(mesh.devices)


def test_a_tuned_backend_is_the_untuned_call_at_the_winner(card):
    """A sweep on the card: each trial on a named route of kernel 1, the
    winner among the candidates; the tuned ``hopper`` call bit-equal to the
    untuned op forced to the winner's ``exec_blocks``; a second call sweeps
    nothing."""
    at.clear_autotune_cache()
    try:
        coo, csf, fs = _case(card, 1)
        be = backends.get("hopper", autotune=True)
        tuned = be.mttkrp(csf, fs, 1)
        (sweep,) = at.sweep_log()
        assert all(t["route"] in sm.ROUTES and t["median_s"] > 0 for t in sweep["trials"])
        won = sweep["winner"]["exec_blocks"]
        assert {"exec_blocks": won} in at.candidates(sweep["key"])
        assert torch.equal(tuned, fused_stream_mttkrp_op(csf, fs, exec_blocks=won))
        assert torch.equal(be.mttkrp(csf, fs, 1), tuned) and len(at.sweep_log()) == 1
        exact = tstream.stream_mttkrp(csf, fs)
        assert float(torch.linalg.norm(tuned - exact) / torch.linalg.norm(exact)) < 0.05
    finally:
        at.clear_autotune_cache()
