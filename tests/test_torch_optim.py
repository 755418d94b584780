"""The port's AdamW and int8 gradient compression held against the JAX
reference on the CPU.

* ``apply_updates`` on the reference's own gradients (those of one reduced
  granite-8b batch, jitted once a module), from the reference's own state
  carried over by ``convert.train_state``: master, m and v within 1e-6 of
  each leaf's max |x| after two steps, for the plain state, a bf16 first
  moment and a factored second moment (f32 sums in another order; a bf16
  ``m`` may round one ulp apart where the f32 sums differ, so it is held
  within one bf16 ulp of its max); grad norm and lr within 1e-6 relative.
* The schedule: the warmup exactly; the cosine part within one f32 ulp of
  ``cos`` carried through its factor, plus one ulp of the result (XLA's and
  PyTorch's CPU ``cos`` differ by an ulp; at ``t = 1`` the ``1 + cos``
  cancellation makes that a few ulps of the lr), at steps 0–200.
* Compression: int8 codes and scales equal to the reference's run eagerly.
* The reference's own compression tests, mirrored.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist.compression import compress_int8 as jcompress_int8
from repro.dist.compression import compress_tree as jcompress_tree
from repro.dist.compression import decompress_int8 as jdecompress_int8
from repro.models.registry import get_config as jget_config
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import apply_updates as japply_updates
from repro.optim import init_state as jinit_state
from repro.optim import schedule as jschedule
from repro.optim import state_structs as jstate_structs
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_loss_fn as jmake_loss_fn
from repro_torch import convert
from repro_torch._tree import leaf_sets
from repro_torch.dist.compression import (compress_int8, compress_tree, decompress_int8,
                                          make_grad_transform)
from repro_torch.models.config import ArchConfig
from repro_torch.optim import (AdamWConfig, apply_updates, clip_by_global_norm, init_state,
                               schedule, state_structs)

OPT_CASES = {
    "plain": {},
    "bf16_m": {"m_dtype": "bfloat16"},
    "factored_v": {"factored_v": True},
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference_grads():
    """The reduced granite-8b's params and the reference's gradients of two
    batches (f32), as numpy trees."""
    jcfg = jget_config("granite_8b").reduced()
    params, _ = jinit_train_state(jax.random.PRNGKey(0), jcfg)
    grad = jax.jit(jax.grad(jmake_loss_fn(jcfg)))
    rng = np.random.default_rng(3)
    grads = []
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (4, 17), dtype=np.int32)
        g = grad(params, {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})
        grads.append(_np(g))
    return jcfg, _np(params), grads


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    top = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * top, (err, top)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_apply_updates_matches_reference(reference_grads, case):
    jcfg, params, grads = reference_grads
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, **OPT_CASES[case])
    jopt_cfg, opt_cfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    jstate = jinit_state(jax.tree.map(jnp.asarray, params), jopt_cfg)
    state = convert.train_state(_np(jstate), device="cpu")
    for g in grads:
        jp, jstate, jm = japply_updates(jstate, jax.tree.map(jnp.asarray, g), jopt_cfg,
                                        param_dtype=jnp.float32)
        p, state, m = apply_updates(state, convert.model_params(g, cfg, device="cpu"), opt_cfg,
                                    param_dtype=torch.float32)
        _close(m["grad_norm"], jm["grad_norm"], 1e-6)
        _close(m["lr"], jm["lr"], 1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 2
    want = convert.train_state(_np(jstate), device="cpu")
    for part in ("master", "m", "v"):
        got = dict(leaf_sets(state[part]))
        ref = dict(leaf_sets(want[part]))
        assert set(got) == set(ref), part
        for path, t in got.items():
            assert t.dtype == ref[path].dtype, (part, path)
            if t.dtype == torch.bfloat16:  # one bf16 ulp (2^-8 of the max) at most
                _close(t, ref[path].float().numpy(), 2 ** -8)
            else:
                _close(t, ref[path].numpy(), 1e-6)
    got_params = dict(leaf_sets(p))
    for path, t in leaf_sets(convert.model_params(_np(jp), cfg, device="cpu")):
        for a, b in zip(got_params[path], t) if isinstance(t, list) else [(got_params[path], t)]:
            _close(a, b.numpy(), 1e-6)


def test_factored_v_keeps_the_reference_stacked_factors(reference_grads):
    """A stacked norm weight (G, d) is factored across groups, as the
    reference factors it; a (d, ff) weight per group."""
    jcfg, params, _ = reference_grads
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    tp = convert.model_params(params, cfg, device="cpu")
    state = init_state(tp, AdamWConfig(factored_v=True, m_dtype="bfloat16"))
    ref = jstate_structs(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params),
                         JAdamWConfig(factored_v=True, m_dtype="bfloat16"))
    want = {p: (tuple(s.shape), str(s.dtype))
            for p, s in leaf_sets(ref)}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in leaf_sets(state)}
    assert got == want
    wn = state["v"]["blocks"]["layer0"]["pre_norm"]["w"]
    assert set(wn) == {"row", "col"} and wn["row"].shape == (cfg.num_groups,)
    meta = state_structs(tp, AdamWConfig(factored_v=True, m_dtype="bfloat16"))
    assert {p: (tuple(t.shape), t.dtype) for p, t in leaf_sets(meta)} == \
        {p: (tuple(t.shape), t.dtype) for p, t in leaf_sets(state)}
    assert all(t.device.type == "meta" for _, t in leaf_sets(meta))


def test_schedule_shape():
    oc = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(schedule(oc, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(schedule(oc, torch.tensor(10, dtype=torch.int32))) - 1.0) < 0.01
    assert float(schedule(oc, torch.tensor(100, dtype=torch.int32))) <= 0.11


@pytest.mark.parametrize("kw", [{}, {"lr": 1.0, "warmup_steps": 10, "total_steps": 100},
                                {"lr": 1e-3, "warmup_steps": 5, "total_steps": 60},
                                {"lr": 3e-4, "warmup_steps": 0, "total_steps": 150}],
                         ids=["default", "short", "train_test", "no_warmup"])
def test_schedule_matches_reference(kw):
    steps = np.arange(0, 201, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jschedule(JAdamWConfig(**kw), s))(jnp.asarray(steps)))
    got = np.array([float(schedule(AdamWConfig(**kw), torch.tensor(s))) for s in steps],
                   np.float32)
    cfg = AdamWConfig(**kw)
    warm = steps < cfg.warmup_steps
    np.testing.assert_array_equal(got[warm], want[warm])
    # one ulp of cos (<= 2^-23), carried through lr * (1 - min_lr_frac) / 2,
    # plus one ulp of the result
    tol = cfg.lr * (1 - cfg.min_lr_frac) * 0.5 * 2.0 ** -23 + np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def test_clip_by_global_norm():
    g = {"a": torch.full((3, 4), 2.0), "b": [torch.ones(5), torch.ones(5)]}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - float(np.sqrt(48 + 10))) < 1e-5
    total = sum(float(t.square().sum()) for _, leaf in leaf_sets(clipped)
                for t in (leaf if isinstance(leaf, list) else [leaf]))
    assert abs(total - 1.0) < 1e-5
    small, _ = clip_by_global_norm(g, 100.0)
    assert torch.equal(small["a"], g["a"])


@pytest.mark.parametrize("block", [None, 64], ids=["per_tensor", "blocks_64"])
def test_compress_int8_codes_equal_reference(block):
    x = (np.random.default_rng(7).standard_normal((8, 128)) *
         np.linspace(0.01, 10.0, 8)[:, None]).astype(np.float32)
    jq, js = jcompress_int8(jnp.asarray(x), block=block)
    q, s = compress_int8(torch.tensor(x), block=block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(decompress_int8(q, s).numpy(),
                                  np.asarray(jdecompress_int8(jq, js)))


@pytest.mark.parametrize("block", [None, 32], ids=["per_tensor", "blocks_32"])
def test_compress_tree_quantizes_a_group_list_as_its_stacked_leaf(block):
    """The reference stacks a model's groups: one scale (per tensor, or per
    block of the stacked leaf) spans every group."""
    rng = np.random.default_rng(11)
    groups = [(rng.standard_normal((8, 16)) * s).astype(np.float32) for s in (1.0, 0.01)]
    carry = [(rng.standard_normal((8, 16)) * 1e-3).astype(np.float32) for _ in groups]
    jdeq, jres = jcompress_tree({"blocks": {"w": jnp.asarray(np.stack(groups))}},
                                {"blocks": {"w": jnp.asarray(np.stack(carry))}}, block=block)
    deq, res = compress_tree({"blocks": [{"w": torch.tensor(g)} for g in groups]},
                             {"blocks": [{"w": torch.tensor(c)} for c in carry]}, block=block)
    for g in range(2):
        np.testing.assert_array_equal(deq["blocks"][g]["w"].numpy(),
                                      np.asarray(jdeq["blocks"]["w"][g]))
        np.testing.assert_array_equal(res["blocks"][g]["w"].numpy(),
                                      np.asarray(jres["blocks"]["w"][g]))


def test_compression_roundtrip():
    g = torch.randn(64, generator=torch.Generator().manual_seed(0)) * 3.0
    q, s = compress_int8(g)
    deq = decompress_int8(q, s)
    assert float((deq - g).abs().max()) <= float(s) / 2 + 1e-6


def test_compression_error_feedback():
    g = {"a": torch.randn(32, generator=torch.Generator().manual_seed(0)),
         "b": [torch.randn(4, 8, generator=torch.Generator().manual_seed(1))]}
    deq, res = compress_tree(g)
    torch.testing.assert_close(deq["a"] + res["a"], g["a"], rtol=1e-6, atol=0)
    torch.testing.assert_close(deq["b"][0] + res["b"][0], g["b"][0], rtol=1e-6, atol=0)
    # the carry is added back before the next round's quantization
    deq2, res2 = compress_tree(g, res)
    for a, r, x, r0 in ((deq2["a"], res2["a"], g["a"], res["a"]),
                        (deq2["b"][0], res2["b"][0], g["b"][0], res["b"][0])):
        torch.testing.assert_close(a + r, x + r0, rtol=1e-6, atol=1e-7)
    assert make_grad_transform(False) is None
    torch.testing.assert_close(make_grad_transform(True)(g)["a"], deq["a"], rtol=0, atol=0)


def test_compress_int8_blockwise_error_bound():
    # one huge outlier per block must not poison the others' quantization
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(4, 64, generator=gen) * torch.linspace(0.01, 100.0, 4)[:, None]
    q, s = compress_int8(g, block=64)
    assert q.shape == g.shape and s.shape == (4, 1)
    deq = decompress_int8(q, s)
    err = (deq - g).abs().reshape(4, 64)
    # per-element error bounded by its own block's quantization step
    assert bool(torch.all(err <= s / 2 + 1e-6))
    # per-tensor mode would smear the largest block's scale over all of them
    q1, s1 = compress_int8(g)
    worst = float((decompress_int8(q1, s1) - g).abs()[0].max())
    assert float(err[0].max()) < worst + 1e-6
    with pytest.raises(ValueError, match="blocks of 48"):
        compress_int8(g, block=48)
