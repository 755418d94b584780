"""The port's logical-axis sharding (``repro_torch.dist.sharding``) held
against the JAX reference's on the CPU.

* The reference's own rule tests (``tests/test_sharding.py``), mirrored on
  the port's logical production meshes (``launch.mesh``, ``meta``).
* Every leaf of ``param_specs``, ``cache_specs`` (``decode_32k``) and the
  optimizer's ``state_spec_tree`` (plain and factored ``v``) of all ten
  archs at full size, on the 16x16 and 2x16x16 meshes, FSDP off and on,
  ``rules`` None and ``--seq-shard``: its spec equal to the reference's
  ``logical_to_spec`` on a mesh of one CPU device repeated (as the
  reference's tests build it), its shard shape equal to the reference's
  ``NamedSharding.shard_shape``. The port keeps per-group lists where the
  reference stacks ``(G, ...)``: a group leaf's spec is the stacked leaf's
  with the leading ``"layers"`` entry (never claimed) dropped.
* ``estimate_fsdp`` equal on every arch x mesh x train / serve, with the
  reference's threshold monkeypatched to the port's H100 figure.
* ``arrays_for_mesh`` equal on array meshes of 1–8, on the 2-D and 3-D
  meshes, and under rules.
"""
import numpy as np
import jax
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import Mesh, NamedSharding as JNamedSharding

from repro.dist import sharding as jsharding
from repro.launch.shapes import SHAPES as JSHAPES
from repro.models.layers import shapes_of as jshapes_of
from repro.models.registry import ARCH_IDS as JARCH_IDS
from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import state_spec_tree as jstate_spec_tree
from repro.optim import state_structs as jstate_structs
from repro.sparse.partition import arrays_for_mesh as jarrays_for_mesh
from repro_torch._tree import leaf_sets
from repro_torch.dist.sharding import (FSDP_THRESHOLD_BYTES, P, estimate_fsdp, logical_to_spec,
                                       tree_shardings)
from repro_torch.launch.mesh import (ModelMesh, chips, make_array_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.shapes import dec_len
from repro_torch.models.layers import as_dtype, shapes_of, specs_of
from repro_torch.models.registry import ARCH_IDS, get_config, get_module
from repro_torch.optim import AdamWConfig, state_spec_tree, state_structs
from repro_torch.sparse import arrays_for_mesh

M2D = make_production_mesh()
M3D = make_production_mesh(multi_pod=True)
SEQ_SHARD = {"seq": (("model",), ())}


def _jmesh(shape, axes):
    devs = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes)


JMESHES = {"16x16": _jmesh((16, 16), ("data", "model")),
           "2x16x16": _jmesh((2, 16, 16), ("pod", "data", "model"))}
MESHES = {"16x16": M2D, "2x16x16": M3D}


# --- the reference's rule tests, mirrored --------------------------------

def test_basic_tp():
    assert logical_to_spec(("embed", "ff"), (4096, 14336), M2D) == P(None, "model")


def test_divisibility_fallback_drops_axis():
    # kv_heads=8 cannot shard on model=16
    spec = logical_to_spec(("batch", "seq_kv", "kv_heads", None), (128, 32768, 8, 128), M2D)
    assert spec[0] == "data"
    assert spec[2] is None          # kv dropped
    assert spec[1] == "model"       # seq_kv picked up the leftover axis


def test_priority_kv_heads_beats_seq():
    # kv=16 divides: heads get the model axis, seq stays unsharded
    spec = logical_to_spec(("batch", "seq_kv", "kv_heads", None), (128, 32768, 16, 128), M2D)
    assert spec[2] == "model" and spec[1] is None


def test_batch_takes_pod_and_data():
    assert logical_to_spec(("batch", "seq"), (256, 4096), M3D)[0] == ("pod", "data")


def test_batch_one_unsharded():
    spec = logical_to_spec(("batch", "seq_kv", "kv_heads", None), (1, 524288, 8, 128), M2D)
    assert spec[0] is None
    assert spec[1] is not None      # sequence parallelism kicks in


def test_fsdp_shards_embed():
    assert logical_to_spec(("embed", "ff"), (4096, 14336), M2D, fsdp=True) == P("data", "model")
    spec3 = logical_to_spec(("embed", "ff"), (4096, 24576), M3D, fsdp=True)
    assert spec3[0] == ("pod", "data")


def test_vocab_non_divisible_unsharded():
    assert logical_to_spec(("vocab", "embed"), (256206, 1024), M2D)[0] is None


def test_no_axis_reuse():
    spec = logical_to_spec(("ff", "qdim"), (14336, 4096), M2D)
    assert [s for s in spec if s == "model"] == ["model"]


def test_estimate_fsdp_thresholds():
    """The reference's four cases, at the H100 threshold (50 GB of 80): an
    8B model serves and trains without FSDP on 16 model shards (1 GB and
    7 GB a device), jamba's 400B trains with it; 27B at 23.6 GB a device
    now fits, as 8B at 16 shards would only past 57B."""
    assert FSDP_THRESHOLD_BYTES == 0.625 * 80e9
    assert not estimate_fsdp(8_000_000_000, M2D, training=False)
    assert estimate_fsdp(400_000_000_000, M2D, training=True)
    assert not estimate_fsdp(27_000_000_000, M2D, training=True)
    assert not estimate_fsdp(8_000_000_000, M2D, training=True)
    assert estimate_fsdp(60_000_000_000, M2D, training=True)


# --- the meshes -----------------------------------------------------------

def test_model_meshes():
    assert (M2D.axis_names, M2D.shape, chips(M2D)) == (("data", "model"), (16, 16), 256)
    assert (M3D.axis_names, M3D.shape, chips(M3D)) == (("pod", "data", "model"), (2, 16, 16),
                                                        512)
    assert {d.type for d in M3D.devices} == {"meta"}
    host = make_host_mesh(device="cpu")
    assert host.shape == (1, 1) and host.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()
    with pytest.raises(ValueError, match="devices"):
        ModelMesh(("data",), (2,), ("cpu",))


# --- every leaf of every arch, against the reference ---------------------

def _ref_tree_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _compare(port_specs, port_structs, ref_specs, ref_structs, mesh, jmesh, fsdp, rules):
    """Each leaf set of the port's trees against the reference's leaf at its
    path: spec and shard shape. Returns the number of leaves compared."""
    shapes = dict(leaf_sets(port_structs))
    n = 0
    for path, spec_leaf in leaf_sets(port_specs):
        struct = shapes[path]
        stacked = isinstance(spec_leaf, list)
        axes = tuple(spec_leaf[0] if stacked else spec_leaf)
        shape = tuple((struct[0] if stacked else struct).shape)
        got = logical_to_spec(axes, shape, mesh, fsdp, rules)
        got_shard = tree_shardings(struct[0] if stacked else struct, axes, mesh, fsdp,
                                   rules).shard_shape(shape)
        r_axes = tuple(_ref_tree_at(ref_specs, path))
        r_shape = tuple(_ref_tree_at(ref_structs, path).shape)
        want = jsharding.logical_to_spec(r_axes, r_shape, jmesh, fsdp, rules)
        want_shard = JNamedSharding(jmesh, want).shard_shape(r_shape)
        if stacked:
            assert r_axes == ("layers", *axes) and r_shape == (len(struct), *shape), path
            assert tuple(want) == (None, *got), (path, got, want)
            assert tuple(want_shard) == (len(struct), *got_shard), path
        else:
            assert r_axes == axes and r_shape == shape, path
            assert tuple(want) == tuple(got), (path, got, want)
            assert tuple(want_shard) == tuple(got_shard), path
        n += 1
    return n


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_equals_the_reference(arch, mesh_name):
    assert ARCH_IDS == JARCH_IDS
    mesh, jmesh = MESHES[mesh_name], JMESHES[mesh_name]
    cfg, jcfg = get_config(arch), jget_config(arch)
    mod, jmod = get_module(cfg), jget_module(jcfg)
    dtype = as_dtype(cfg.dtype)
    pdefs, jpdefs = mod.param_defs(cfg), jmod.param_defs(jcfg)
    p_specs, p_structs = specs_of(pdefs), shapes_of(pdefs, dtype)
    jp_specs, jp_structs = jmod.param_specs(jcfg), jshapes_of(jpdefs, jcfg.dtype)

    shape = JSHAPES["decode_32k"]
    if cfg.family == "encdec":
        cargs = (shape.global_batch, dec_len(shape), shape.seq_len)
    else:
        cargs = (shape.global_batch, shape.seq_len)
    cdefs, jcdefs = mod.cache_defs(cfg, *cargs), jmod.cache_defs(jcfg, *cargs)

    counted = 0
    for fsdp in (False, True):
        for rules in (None, SEQ_SHARD):
            counted += _compare(p_specs, p_structs, jp_specs, jp_structs, mesh, jmesh,
                                fsdp, rules)
            counted += _compare(specs_of(cdefs), shapes_of(cdefs, dtype), jmod.cache_specs(
                jcfg, *cargs), jshapes_of(jcdefs, jcfg.dtype), mesh, jmesh, fsdp, rules)
            for ocfg, jocfg in ((None, None), (AdamWConfig(m_dtype="bfloat16", factored_v=True),
                                               JAdamWConfig(m_dtype="bfloat16",
                                                            factored_v=True))):
                s_structs = state_structs(p_structs, ocfg)
                counted += _compare(state_spec_tree(p_specs, p_structs, ocfg), s_structs,
                                    jstate_spec_tree(jp_specs, jp_structs, jocfg),
                                    jstate_structs(jp_structs, jocfg), mesh, jmesh, fsdp,
                                    rules)
    assert counted > 0


@pytest.mark.parametrize("training", [False, True], ids=["serve", "train"])
def test_estimate_fsdp_equals_the_reference(monkeypatch, training):
    monkeypatch.setattr(jsharding, "FSDP_THRESHOLD_BYTES", FSDP_THRESHOLD_BYTES)
    for arch in ARCH_IDS:
        n = get_config(arch).param_count()
        assert n == jget_config(arch).param_count()
        for name, mesh in MESHES.items():
            assert estimate_fsdp(n, mesh, training) \
                == jsharding.estimate_fsdp(n, JMESHES[name], training), (arch, name)


def test_arrays_for_mesh_equals_the_reference():
    rules_set = (None, {"batch": ((), (("model",),))}, {"batch": ((), (("data",),))})
    for n in range(1, 9):
        jmesh = _jmesh((n,), ("array",))
        for rules in rules_set:
            assert arrays_for_mesh(make_array_mesh(n, device="cpu"), rules=rules) \
                == jarrays_for_mesh(jmesh, rules=rules) == n
        assert arrays_for_mesh(make_array_mesh(n, device="cpu"), "ff") \
            == jarrays_for_mesh(jmesh, "ff") == 1
    for shape, axes in (((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        mesh = ModelMesh(axes, shape, ("meta",) * int(np.prod(shape)))
        jmesh = _jmesh(shape, axes)
        for axis in ("batch", "ff", "embed", "seq"):
            for rules in rules_set + (SEQ_SHARD,):
                assert arrays_for_mesh(mesh, axis, rules) \
                    == jarrays_for_mesh(jmesh, axis, rules), (shape, axis, rules)
