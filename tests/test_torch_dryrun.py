"""The port's dry run (``launch.shapes``, ``launch.roofline``,
``launch.dryrun``) held against the JAX reference on the CPU.

* ``SHAPES``, ``applicable``, ``token_specs`` (as ``meta`` tensors) and
  ``token_logical_axes`` equal to the reference's for every arch x shape.
* ``model_flops``, ``kv_cache_bytes`` and ``ideal_seconds`` equal to the
  reference's, its TPU constants monkeypatched to the port's H100 ones.
* The reference smoke's three cells (``tests/test_dryrun_smoke.py``:
  granite-8b train, mamba2-370m decode and granite-moe prefill, reduced, at
  seq 64, batch 8, a 2x4 logical mesh, microbatches 2), lowered on
  ``meta``: counted FLOPs > 0; per-device argument bytes equal to the sum
  of the reference's shard shapes over its own structs and shardings; the
  train cell's count twice one microbatch's.
* The CLI on reduced cells, writing its JSON; ``long_500k`` on a
  full-attention arch and a ``--psram-int8`` train cell are ``SKIP`` rows
  with the reference's reasons.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import Mesh

from repro.dist.sharding import logical_to_spec as jlogical_to_spec
from repro.dist.sharding import tree_shardings as jtree_shardings
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshapes
from repro.models.layers import shapes_of as jshapes_of
from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import state_spec_tree as jstate_spec_tree
from repro.optim import state_structs as jstate_structs
from repro_torch.launch import dryrun, roofline, shapes
from repro_torch.launch.mesh import ModelMesh
from repro_torch.models.registry import ARCH_IDS, get_config

MESH = ModelMesh(("data", "model"), (2, 4), ("meta",) * 8)
SMOKE = (("granite_8b", "train"), ("mamba2_370m", "decode"), ("granite_moe_1b_a400m", "prefill"))


def _smoke_shape(kind):
    """A cell of ``kind`` at the reference smoke's seq 64, batch 8."""
    return shapes.ShapeSpec("smoke", seq_len=64, global_batch=8, kind=kind)


def _jmesh():
    return Mesh(np.array([jax.devices()[0]] * 8).reshape(2, 4), ("data", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_equal_the_reference(arch):
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    assert shapes.LONG_OK_FAMILIES == jshapes.LONG_OK_FAMILIES
    assert shapes.ENC_DEC_FRAC == jshapes.ENC_DEC_FRAC
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in shapes.SHAPES.items():
        jshape = jshapes.SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        assert shapes.applicable(cfg, shape) == jshapes.applicable(jcfg, jshape)
        got, want = shapes.token_specs(cfg, shape), jshapes.token_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k in got:
            assert got[k].device.type == "meta", k
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
        assert shapes.token_logical_axes(cfg, shape) == jshapes.token_logical_axes(jcfg, jshape)


def test_roofline_arithmetic_equals_the_reference(monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert roofline._num_attn_layers(cfg) == jroofline._num_attn_layers(jcfg)
        for shape in shapes.SHAPES.values():
            args = (shape.kind, shape.seq_len, shape.global_batch)
            assert roofline.model_flops(cfg, *args) == jroofline.model_flops(jcfg, *args)
            assert roofline.kv_cache_bytes(cfg, shape.seq_len, shape.global_batch) \
                == jroofline.kv_cache_bytes(jcfg, shape.seq_len, shape.global_batch)
            for chips, shards in ((256, 16), (512, 16), (8, 4), (1, 1)):
                assert roofline.ideal_seconds(cfg, *args, chips, shards) \
                    == jroofline.ideal_seconds(jcfg, *args, chips, shards)


def _smoke_cfg(arch, kind, psram=False):
    (cfg, _), _ = dryrun.build_cell(arch, "train_4k")
    return dataclasses.replace(cfg.reduced(), attention_impl="chunked", attn_chunk=16,
                               remat=(kind == "train"), psram_projections=psram)


def _reference_argument_bytes(arch, shape):
    """Per-device argument bytes of the reference's cell on its own 2x4
    mesh: its structs, its shardings, its shard shapes."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), attention_impl="chunked",
                               attn_chunk=16)
    mod = jget_module(jcfg)
    jmesh = _jmesh()
    fsdp = False
    p_structs = jshapes_of(mod.param_defs(jcfg), jcfg.dtype)
    trees = [(p_structs, jtree_shardings(p_structs, mod.param_specs(jcfg), jmesh, fsdp))]
    batch = jshapes.token_specs(jcfg, shape)
    trees.append((batch, jax.tree.map(
        lambda s, ax: jax.sharding.NamedSharding(jmesh, jlogical_to_spec(tuple(ax), s.shape,
                                                                         jmesh, fsdp)),
        batch, jshapes.token_logical_axes(jcfg, shape),
        is_leaf=lambda x: isinstance(x, (tuple, list)))))
    if shape.kind == "train":
        ocfg = JAdamWConfig()
        o_structs = jstate_structs(p_structs, ocfg)
        trees.append((o_structs, jtree_shardings(
            o_structs, jstate_spec_tree(mod.param_specs(jcfg), p_structs, ocfg), jmesh, fsdp)))
    elif shape.kind == "decode":
        cdefs = mod.cache_defs(jcfg, shape.global_batch, shape.seq_len)
        c_structs = jshapes_of(cdefs, jcfg.dtype)
        trees.append((c_structs, jtree_shardings(c_structs, mod.cache_specs(
            jcfg, shape.global_batch, shape.seq_len), jmesh, False)))
        trees.append((jax.ShapeDtypeStruct((), np.int32),
                      jax.sharding.NamedSharding(jmesh, jlogical_to_spec((), (), jmesh))))
    total = 0
    for structs, shards in trees:
        for s, sh in zip(jax.tree.leaves(structs), jax.tree.leaves(
                shards, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))):
            total += math.prod(sh.shard_shape(s.shape)) * np.dtype(s.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,kind", SMOKE, ids=[f"{a}:{k}" for a, k in SMOKE])
def test_smoke_cells_lower_on_meta(arch, kind):
    cfg = _smoke_cfg(arch, kind)
    shape = _smoke_shape(kind)
    res, cell = dryrun.lower_cell(cfg, shape, MESH, microbatches=2, verbose=False)
    r = res["roofline"]
    assert r["dot_flops"] > 0 and r["bytes_essential"] > 0
    assert res["chips"] == 8 and res["mesh"] == "2x4" and not res["fsdp"]
    assert res["memory"]["argument_bytes"] == _reference_argument_bytes(arch, shape)
    assert res["memory"]["temp_bytes"] is None and res["compile_s"] is None
    # the 2x4 mesh's collectives, traced under the fake group of 8 and priced
    # by the ring model over NVLink
    assert r["collective_s"] > 0 and set(res["why"]) == {"temp_bytes", "compile_s"}
    assert r["by_collective"]["all-reduce"]["count"] > 0
    assert r["collective_s"] == r["collective_wire_bytes"] / 450e9
    assert {t.device.type for t in torch.utils._pytree.tree_leaves(cell["params"])} == {"meta"}
    if kind == "train":
        one, _ = dryrun.lower_cell(cfg, dataclasses.replace(shape, global_batch=4), MESH,
                                   microbatches=1, verbose=False)
        assert r["dot_flops"] == 2 * one["roofline"]["dot_flops"]
        assert res["memory"]["alias_bytes"] == res["memory"]["argument_bytes"] \
            - res["memory"]["argument_split"]["batch"]
    if kind == "decode":
        assert res["memory"]["alias_bytes"] == res["memory"]["argument_split"]["cache"]


def test_psram_train_cell_lowers():
    """A ``--psram-projections`` train cell traces through kernel 2's plain
    version and its scales-only gradient."""
    cfg = _smoke_cfg("granite_8b", "train", psram=True)
    res, _ = dryrun.lower_cell(cfg, dataclasses.replace(_smoke_shape("train"),
                                                        global_batch=4),
                               MESH, microbatches=1, verbose=False)
    assert res["roofline"]["dot_flops"] > 0 and res["psram_projections"]


def test_cli_writes_its_json(tmp_path, capsys):
    rows = dryrun.main(["--device", "meta", "--arch", "mamba2_370m,granite_8b",
                        "--shape", "decode_32k,long_500k", "--reduced", "--outdir",
                        str(tmp_path)])
    out = capsys.readouterr().out
    assert [r.get("skipped") is None for r in rows] == [True, True, True, False]
    assert "SKIP  granite_8b" in out and "full-attention arch at 500k" in out
    cell = json.loads((tmp_path / "mamba2_370m_decode_32k_single.json").read_text())
    assert cell["mesh"] == "16x16" and cell["roofline"]["dot_flops"] > 0
    assert len(json.loads((tmp_path / "summary.json").read_text())) == 4
    rows = dryrun.main(["--device", "meta", "--arch", "granite_8b", "--shape", "train_4k",
                        "--reduced", "--psram-int8", "--outdir", str(tmp_path)])
    assert rows[0]["skipped"].startswith("TypeError: grad requires real- or complex-valued")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.main(["--arch", "granite_8b", "--shape", "decode_32k", "--reduced",
                         "--outdir", str(tmp_path)])
