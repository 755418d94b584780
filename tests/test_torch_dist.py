"""``dist.sharding``'s ``hint`` context and ``tree_shardings``, mirrored from
the reference's ``tests/test_dist.py``, on the port's one-device host mesh.

The reference's ``hint`` is a no-op outside a ``use_sharding`` context or
outside a trace, and inside both applies ``with_sharding_constraint``. The
port runs eagerly on one device: outside the context ``hint`` returns the
tensor itself; inside it computes the spec the context gives
(``active_spec``: an axes / shape mismatch raises, as the reference's
assert does) and still returns the tensor itself — on a one-device mesh the
constraint is the identity. A mesh over several cards raises, naming
ROADMAP item 9c.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist.sharding import hint as jhint
from repro.dist.sharding import logical_to_spec as jlogical_to_spec
from repro.dist.sharding import use_sharding as juse_sharding
from repro_torch.dist.sharding import (P, active_spec, hint, logical_to_spec, tree_shardings,
                                       use_sharding)
from repro_torch.launch.mesh import ModelMesh, make_host_mesh


def _jmesh():
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return jax.sharding.Mesh(devs, ("data", "model"))


def test_hint_noop_outside_mesh():
    x = torch.ones((8, 4))
    assert hint(x, ("batch", "seq")) is x
    # varargs spelling is equivalent
    assert hint(x, "batch", "seq") is x
    assert active_spec(x.shape, ("batch", "seq")) is None
    # no context: even a wrong rank passes through untouched, as in the reference
    assert hint(x, ("batch",)) is x
    xj = jax.numpy.ones((8, 4))
    assert jhint(xj, ("batch",)) is xj


def test_hint_applies_spec_inside_context():
    mesh = make_host_mesh(device="cpu")
    x = torch.ones((8, 4))
    with use_sharding(mesh):
        assert hint(x, ("batch", "ff")) is x
        spec = active_spec(x.shape, ("batch", "ff"))
        with pytest.raises(ValueError, match="rank"):
            hint(x, ("batch",))
    assert active_spec(x.shape, ("batch", "ff")) is None
    expect = logical_to_spec(("batch", "ff"), x.shape, mesh)
    assert spec == expect == P("data", "model")
    jmesh = _jmesh()
    with juse_sharding(jmesh):
        jaxpr = jax.make_jaxpr(lambda a: jhint(a, ("batch", "ff")))(jax.numpy.ones((8, 4)))
    [eqn] = [e for e in jaxpr.eqns if e.primitive.name == "sharding_constraint"]
    assert tuple(eqn.params["sharding"].spec) == tuple(spec)
    assert tuple(jlogical_to_spec(("batch", "ff"), (8, 4), jmesh)) == tuple(spec)
    # a mesh over two cards in one process without a process group: one
    # process a card
    two = ModelMesh(("data", "model"), (2, 1), ("cuda:0", "cuda:1"))
    with pytest.raises(RuntimeError, match="one process a card"):
        with use_sharding(two):
            pass


def test_tree_shardings_mirrors_specs():
    mesh = make_host_mesh(device="cpu")
    structs = {
        "w": torch.empty((8, 4), device="meta"),
        "v": {"row": torch.empty((8,), device="meta")},
        "g": [torch.empty((8, 4), dtype=torch.bfloat16, device="meta")] * 2,
    }
    specs = {"w": ("embed", "ff"), "v": {"row": ("embed",)},
             "g": [("embed", "ff"), ("embed", "ff")]}
    sh = tree_shardings(structs, specs, mesh, fsdp=True)
    assert sh["w"].spec == P("data", "model")
    assert sh["v"]["row"].spec == P("data")
    assert [s.spec for s in sh["g"]] == [P("data", "model")] * 2
    assert sh["w"].shard_shape((8, 4)) == (8, 4)
    assert sh["g"][0].shard_bytes((8, 4), torch.bfloat16) == 64
    assert sh["w"].device == torch.device("cpu")
