"""The dry run's collective term and the spec -> placement mapping, on the CPU.

* :func:`launch.roofline.wire_bytes` equal to the reference's ring model for
  every op and group size.
* The fake-group trace (``launch.roofline.fake_world``: rank 0 of torch's
  ``fake`` process group, DTensors on ``meta``) of a column- then
  row-parallel MLP and of a reduced dense cell on a (2, 4) mesh: the
  counted all-reduces equal the number and bytes derived by hand.
* The reference's XLA collective figures for the same reduced cell are
  printed beside the port's (its dry run in a subprocess with 8 forced host
  devices, as ``tests/test_dryrun_smoke.py`` runs it); not gated: XLA and
  DTensor choose different collectives.
* ``dist.placement.placements``: a spec to DTensor placements, tuple claims
  included (``("pod", "data")`` shards over the product, the first axis
  major, as ``NamedSharding`` lays the blocks), and a tuple out of the
  mesh's order refused.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch.roofline import wire_bytes as jwire_bytes
from repro_torch.dist.placement import Replicate, Shard, placements
from repro_torch.dist.sharding import P
from repro_torch.launch import dryrun, roofline, shapes
from repro_torch.launch.mesh import ModelMesh

MESH = ModelMesh(("data", "model"), (2, 4), ("meta",) * 8)
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
       "other")


@pytest.mark.parametrize("op", OPS)
def test_wire_bytes_equal_reference(op):
    for group in (0, 1, 2, 3, 4, 8, 16, 256, 512):
        for nbytes in (0.0, 1.0, 4096.0, 3.5e9):
            assert roofline.wire_bytes(op, nbytes, 2 * nbytes, group) == \
                jwire_bytes(op, nbytes, 2 * nbytes, group)


def test_link_bandwidth_is_nvlink_each_way():
    assert roofline.LINK_BW == 450e9


def _mlp_cfg():
    from repro_torch.models.registry import get_config
    return get_config("granite_8b").reduced()


def test_column_then_row_mlp_counts_one_all_reduce():
    """x (B, S, d) over "data", wi / wg column-parallel, wo row-parallel on
    "model" (4): one all-reduce of the local (B/2, S, d) f32 partial sums
    over the 4 ranks of "model", nothing else."""
    from repro_torch.dist.placement import distribute
    from repro_torch.dist.sharding import logical_to_spec, use_sharding
    from repro_torch.models.layers import mlp_defs, mlp_fwd, shapes_of, specs_of
    cfg = _mlp_cfg()
    b, s, d = 8, 16, cfg.d_model
    defs = mlp_defs(cfg)
    with roofline.fake_world(MESH) as fake:
        p = {k: distribute(t, fake, logical_to_spec(ax, t.shape, fake))
             for (k, t), ax in zip(shapes_of(defs, torch.float32).items(),
                                   specs_of(defs).values())}
        x = torch.empty((b, s, d), device="meta")
        x = distribute(x, fake, logical_to_spec(("batch", "seq", None), x.shape, fake))
        with use_sharding(fake):
            y, records = roofline.count_collectives(mlp_fwd, p, x, cfg)
        assert tuple(y.placements) == (Shard(0), Replicate())
    per = (b // 2) * s * d * 4
    assert records == [("all-reduce", per, 4)]
    cb, wb, by = roofline.price_collectives(records)
    assert cb == per and wb == 2 * 3 / 4 * per
    assert by == {"all-reduce": {"count": 1, "bytes": per, "wire_bytes": 2 * 3 / 4 * per}}


def _cell(kind):
    (cfg, _), _ = dryrun.build_cell("granite_8b", "train_4k")
    cfg = dataclasses.replace(cfg.reduced(), attention_impl="chunked", attn_chunk=16,
                              remat=False)
    return cfg, shapes.ShapeSpec("smoke", seq_len=64, global_batch=8, kind=kind)


def test_reduced_prefill_cell_all_reduces_by_hand():
    """Reduced granite-8b's prefill on (2, 4): the embedding's sum over the
    vocabulary blocks and two a layer (o and down, row-parallel), each of the
    local (B/2, S, d) f32 activations over the 4 ranks of "model"."""
    cfg, shape = _cell("prefill")
    res, _ = dryrun.lower_cell(cfg, shape, MESH, verbose=False)
    r = res["roofline"]
    per = (shape.global_batch // 2) * shape.seq_len * cfg.d_model * 4
    n = 1 + 2 * cfg.num_layers
    ar = r["by_collective"]["all-reduce"]
    assert ar["count"] == n and ar["bytes"] == n * per
    assert ar["wire_bytes"] == pytest.approx(n * 2 * 3 / 4 * per, rel=1e-12)
    assert r["collective_s"] == pytest.approx(r["collective_wire_bytes"] / 450e9, rel=1e-12)
    assert r["collective_bytes"] >= ar["bytes"]
    print("port", json.dumps({k: v for k, v in r.items()
                              if k.startswith("collective") or k == "by_collective"}))


def test_one_device_cell_has_no_collectives():
    cfg, shape = _cell("decode")
    res, _ = dryrun.lower_cell(cfg, shape, ModelMesh(("data", "model"), (1, 1), ("meta",)),
                               verbose=False)
    assert res["roofline"]["collective_s"] == 0 and res["roofline"]["by_collective"] == {}


REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax
from repro.launch.dryrun import build_cell, lower_cell
from repro.launch.shapes import ShapeSpec
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
(cfg, _), _ = build_cell("granite_8b", "train_4k")
cfg = dataclasses.replace(cfg.reduced(), attention_impl="chunked", attn_chunk=16, remat=False)
res, _, _ = lower_cell(cfg, ShapeSpec("smoke", seq_len=64, global_batch=8, kind="prefill"),
                       mesh, microbatches=1)
r = res["roofline"]
print("RESULT " + json.dumps({k: r[k] for k in ("collective_bytes", "collective_wire_bytes",
                                                "by_collective")}))
"""


@pytest.mark.timeout(300)
def test_reference_xla_collectives_reported_beside(capsys):
    """The reference's XLA figures for the same cell, printed (not gated)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH="src"), cwd=root, timeout=280)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    xla = json.loads(line[len("RESULT "):])
    cfg, shape = _cell("prefill")
    port = dryrun.lower_cell(cfg, shape, MESH, verbose=False)[0]["roofline"]
    print("xla ", json.dumps(xla))
    print("port", json.dumps(port["by_collective"]))
    assert xla["collective_bytes"] >= 0 and port["collective_bytes"] > 0


@pytest.mark.parametrize("spec,axes,want", [
    (P("data", "model"), ("data", "model"), (Shard(0), Shard(1))),
    (P(None, "model"), ("data", "model"), (Replicate(), Shard(1))),
    (P("model", None), ("data", "model"), (Replicate(), Shard(0))),
    (P(), ("data", "model"), (Replicate(), Replicate())),
    (P(("pod", "data"), None, "model"), ("pod", "data", "model"),
     (Shard(0), Shard(0), Shard(2))),
    (P(("data", "model")), ("data", "model"), (Shard(0), Shard(0))),
    (P(None, ("pod", "data")), ("pod", "data", "model"), (Shard(1), Shard(1), Replicate())),
], ids=["both", "column", "row", "replicated", "pod-data", "data-model", "tuple-dim1"])
def test_spec_to_placements(spec, axes, want):
    assert placements(spec, axes) == want


def test_tuple_claim_out_of_mesh_order_refused():
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements(P(("data", "pod")), ("pod", "data", "model"))


def test_tuple_claim_blocks_are_named_sharding_blocks():
    """On a (2, 2, 2) ("pod", "data", "model") mesh a dimension claimed by
    ("pod", "data") is cut in 4 blocks, the block of coordinates (i, j)
    being i * 2 + j, as jax.sharding.NamedSharding lays them; the DTensor
    placements give each fake rank exactly that block."""
    from repro_torch.dist.placement import distribute
    mesh = ModelMesh(("pod", "data", "model"), (2, 2, 2), ("meta",) * 8)
    with roofline.fake_world(mesh) as fake:
        t = torch.empty((8, 6), device="meta")
        d = distribute(t, fake, P(("pod", "data"), "model"))
        assert tuple(d.placements) == (Shard(0), Shard(0), Shard(1))
        assert tuple(d.to_local().shape) == (2, 3)
    # every rank's block: _block (what distribute keeps) at each coordinate
    from repro_torch.dist.placement import _block

    class _Coord:  # the two DeviceMesh methods _block reads
        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return list(self.coord)

        def size(self, i):
            return 2

    t = torch.arange(48).reshape(8, 6)
    for i in range(2):
        for j in range(2):
            for k in range(2):
                blk = _block(t, _Coord((i, j, k)), (Shard(0), Shard(0), Shard(1)))
                row0 = (i * 2 + j) * 2          # NamedSharding's block (i, j) of 4
                assert torch.equal(blk, t[row0:row0 + 2, 3 * k:3 * k + 3])
