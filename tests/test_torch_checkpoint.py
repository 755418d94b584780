"""The port's checkpoints: the reference's own tests mirrored, and the
on-disk format shared with the reference.

* A checkpoint the reference writes (a reduced granite-8b's params, its
  AdamW state after one step — a factored second moment included — and an
  error-feedback residual) restores in the port equal, bit for bit, to
  ``convert`` of the same trees; one the port writes restores in the
  reference equal to the trees it came from.
* Written by either package, the same tree gives the same bytes in every
  archive member (``a<i>.npy``: header and data) and the same
  ``tree.json`` — bf16 leaves under the reference's ``<V2`` included.
* A bf16 leaf the reference writes restores in the port bit-equal (the
  reference itself cannot load it: ``jnp.asarray`` refuses the ``|V2``
  dtype ``np.load`` returns — its quirk, not the port's).
* Damaged bytes, a missing leaf or a wrong shape raise the port's
  ``CheckpointError`` with the reference's wording.
"""
import dataclasses
import json
import os
import tempfile
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_state as jinit_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch._tree import leaf_sets
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.models.config import ArchConfig


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal_trees(got, want):
    g, w = dict(leaf_sets(got)), dict(leaf_sets(want))
    assert set(g) == set(w)
    for path, a in g.items():
        for x, y in zip(a, w[path]) if isinstance(a, list) else [(a, w[path])]:
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert torch.equal(x, y), path


@pytest.fixture(scope="module")
def reference_state():
    """(cfg, jax tree) of a reduced granite-8b after one reference step:
    params, a factored AdamW state, and a nonzero residual."""
    jcfg = jget_config("granite_8b").reduced()
    params = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    oc = JAdamWConfig(lr=1e-3, warmup_steps=1, factored_v=True)
    step = jax.jit(jmake_train_step(jcfg, oc, compress_grads=True, error_feedback=True))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 17), dtype=np.int32)
    res = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    params, opt, _, res = step(params, jinit_state(params, oc),
                               {"tokens": jnp.asarray(toks[:, :-1]),
                                "labels": jnp.asarray(toks[:, 1:])}, res)
    return ArchConfig(**dataclasses.asdict(jcfg)), {"params": params, "opt": opt,
                                                    "residual": res}


def _port_tree(cfg, tree):
    t = _np(tree)
    return {"params": convert.model_params(t["params"], cfg, device="cpu"),
            "opt": convert.train_state(t["opt"], device="cpu"),
            "residual": convert.model_params(t["residual"], cfg, device="cpu")}


def test_reference_checkpoint_restores_in_the_port(reference_state, tmp_path):
    cfg, tree = reference_state
    JCheckpointManager(str(tmp_path)).save(7, tree, blocking=True)
    want = _port_tree(cfg, tree)
    got, step = CheckpointManager(str(tmp_path)).restore(_zeros_like(want))
    assert step == 7
    _equal_trees(got, want)
    assert isinstance(got["params"]["blocks"], list) and len(got["params"]["blocks"]) == 2


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def test_port_checkpoint_restores_in_the_reference(reference_state, tmp_path):
    cfg, tree = reference_state
    CheckpointManager(str(tmp_path)).save(9, _port_tree(cfg, tree), blocking=True)
    like = jax.tree.map(jnp.zeros_like, tree)
    got, step = JCheckpointManager(str(tmp_path)).restore(like)
    assert step == 9
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_tree_same_bytes(reference_state, tmp_path, dtype):
    cfg, tree = reference_state
    tree = {"params": jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), tree["params"]),
            "opt": tree["opt"]}
    port = {"params": convert.model_params(_np(tree["params"]), cfg, device="cpu"),
            "opt": convert.train_state(_np(tree["opt"]), device="cpu")}
    JCheckpointManager(str(tmp_path / "ref")).save(3, tree, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(3, port, blocking=True)
    for name in ("arrays_h0.npz", "tree.json"):
        a, b = (tmp_path / side / "step_000000003" / name for side in ("ref", "port"))
        if name.endswith(".npz"):
            assert _members(a) == _members(b)
        else:
            assert a.read_bytes() == b.read_bytes()
    if dtype == "bfloat16":  # the port reads its bf16 leaves back bit for bit
        got, _ = CheckpointManager(str(tmp_path / "ref")).restore(_zeros_like(port))
        _equal_trees(got, port)
        assert got["params"]["embed"].dtype == torch.bfloat16
        meta = json.loads((tmp_path / "ref" / "step_000000003" / "tree.json").read_text())
        assert "bfloat16" in meta["dtypes"]


def test_restore_onto_a_mesh_raises(tmp_path):
    """``restore(shardings=)`` on a one-device mesh equals ``restore()``; a
    mesh over several cards, or a logical one, raises."""
    from repro_torch.dist.sharding import tree_shardings
    from repro_torch.launch.mesh import ModelMesh, make_host_mesh, make_production_mesh
    cm = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(8, dtype=torch.float32).reshape(2, 4),
            "g": [torch.ones(4, dtype=torch.bfloat16), torch.zeros(4, dtype=torch.bfloat16)]}
    cm.save(1, tree, blocking=True)
    like = {"w": torch.zeros(2, 4), "g": [torch.zeros(4, dtype=torch.bfloat16)] * 2}
    specs = {"w": ("batch", "ff"), "g": [("embed",), ("embed",)]}
    got, step = cm.restore(like, shardings=tree_shardings(like, specs, make_host_mesh(
        device="cpu")))
    want, _ = cm.restore(like)
    assert step == 1
    _equal_trees(got, want)
    two = ModelMesh(("data", "model"), (2, 1), ("cuda:0", "cuda:1"))
    with pytest.raises(RuntimeError, match="one process a card"):
        cm.restore(like, shardings=tree_shardings(like, specs, two))
    with pytest.raises(ValueError, match="logical"):
        cm.restore(like, shardings=tree_shardings(like, specs, make_production_mesh()))


def test_async_save_snapshots_before_returning(tmp_path):
    """The trainer updates its state in place after ``save`` returns."""
    w = torch.arange(16, dtype=torch.float32)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": w, "g": [w[:4].clone(), w[4:8].clone()]})
    w.add_(100.0)
    cm.wait()
    got, _ = cm.restore({"w": torch.zeros(16), "g": [torch.zeros(4), torch.zeros(4)]})
    assert torch.equal(got["w"], torch.arange(16, dtype=torch.float32))
    assert torch.equal(got["g"][1], torch.arange(4, 8, dtype=torch.float32))


def _key_tensor(shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_checkpoint_roundtrip_and_atomicity():
    tree = {"w": _key_tensor((8, 8)), "step": torch.tensor(3, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as td:
        cm = CheckpointManager(td)
        cm.save(10, tree, blocking=True)
        cm.save(20, tree, blocking=True)
        # fake an aborted save: dir without `done`
        os.makedirs(os.path.join(td, "step_000000030"))
        like = {"w": torch.zeros((8, 8)), "step": torch.tensor(0, dtype=torch.int32)}
        restored, step = cm.restore(like)
        assert step == 20
        assert torch.equal(restored["w"], tree["w"])
        assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 3
        assert cm.latest_step() == 20


def test_checkpoint_corrupt_load_is_a_clear_error():
    """Damaged bytes under a committed ``done`` marker must surface as
    CheckpointError naming the step — not a zipfile/json traceback."""
    tree = {"w": _key_tensor((8, 8)), "step": torch.tensor(3, dtype=torch.int32)}
    like = {"w": torch.zeros((8, 8)), "step": torch.tensor(0, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as td:
        cm = CheckpointManager(td)
        cm.save(10, tree, blocking=True)
        sdir = os.path.join(td, "step_000000010")
        # truncated array archive
        npz = os.path.join(sdir, "arrays_h0.npz")
        blob = open(npz, "rb").read()
        open(npz, "wb").write(blob[: len(blob) // 2])
        with pytest.raises(CheckpointError, match="step 10.*corrupt"):
            cm.restore(like)
        open(npz, "wb").write(blob)          # heal, then damage the metadata
        open(os.path.join(sdir, "tree.json"), "w").write('{"paths": [')
        with pytest.raises(CheckpointError, match="corrupt or truncated"):
            cm.restore(like)


def test_checkpoint_tree_mismatch_is_a_clear_error():
    tree = {"w": _key_tensor((8, 8))}
    with tempfile.TemporaryDirectory() as td:
        cm = CheckpointManager(td)
        cm.save(5, tree, blocking=True)
        with pytest.raises(CheckpointError, match="missing leaf"):
            cm.restore({"v": torch.zeros((8, 8))})
        with pytest.raises(CheckpointError, match="shape"):
            cm.restore({"w": torch.zeros((4, 4))})
        with pytest.raises(CheckpointError, match="shape"):     # a group list's stacked shape
            cm.restore({"w": [torch.zeros(8), torch.zeros(8), torch.zeros(8)]})
        # an honest absence is still FileNotFoundError, not corruption
        with tempfile.TemporaryDirectory() as empty:
            with pytest.raises(FileNotFoundError):
                CheckpointManager(empty).restore(tree)


def test_checkpoint_keeps_n():
    tree = {"w": torch.ones(4)}
    with tempfile.TemporaryDirectory() as td:
        cm = CheckpointManager(td, keep=2)
        for s in (1, 2, 3, 4):
            cm.save(s, tree, blocking=True)
        assert cm.committed_steps() == [3, 4]
