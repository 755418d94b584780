"""The port's MoE family (``models/moe.py``, ``psram_einsum``) held against
the JAX reference on the CPU.

Token-choice top-k routing with position-priority capacity. Tolerances,
each with its reason:

* ``capacity`` exact; the routing (which expert, which slot, which
  assignments drop) exact;
* ``moe_fwd`` in f32 within 1e-5 of max |y| (the experts' f32 einsums and
  the softmax sum in another order), dropless and with drops;
* ``psram_einsum`` **bit-equal** to the reference's run op by op (integer
  codes, an exact contraction, the same ADC and dequant), on the
  reference's own stored int8 words carried over by ``convert``;
* the served family: greedy tokens equal to the reference's engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import photonic_layer as jpl
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.config import ArchConfig as JArchConfig
from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.core import photonic_layer as tpl
from repro_torch.models import layers as tlayers
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_config
from repro_torch.serve import ServeEngine

MOE_ARCHS = ["granite_moe_1b_a400m", "dbrx_132b"]


def _cfg(**kw):
    base = dict(name="moe-test", family="moe", d_model=32, d_ff=64, num_experts=4, top_k=2,
                d_ff_expert=64, act="swiglu", dtype="float32")
    base.update(kw)
    return ArchConfig(**base)


def _jcfg(cfg):
    return JArchConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=0):
    """The reference's ``moe_defs`` params (``init_params`` of a PRNGKey),
    as numpy and as the port's tensors."""
    jp = jlayers.init_params(jax.random.PRNGKey(seed), jmoe.moe_defs(_jcfg(cfg)))
    np_p = jax.tree.map(np.array, jp)
    return np_p, jax.tree.map(lambda a: convert._array_tensor(a, "cpu"), np_p)


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (np.abs(got - want).max(), scale)


# ---------------------------------------------------------------- capacity


@pytest.mark.parametrize("tokens", [1, 3, 4, 8, 64, 8192])
@pytest.mark.parametrize("factor", [None, 1e-9, 0.5, 1.0, 1.25, 100.0])
def test_capacity_is_the_reference_capacity(tokens, factor):
    for cfg in (_cfg(), get_config("granite_moe_1b_a400m"), get_config("dbrx_132b")):
        assert moe.capacity(tokens, cfg, factor) == jmoe.capacity(tokens, _jcfg(cfg), factor)
    cfg = _cfg()
    assert moe.capacity(64, cfg, factor=1.0) == 32  # 64 * 2 / 4
    assert moe.capacity(64, cfg, factor=1.25) == 40
    assert moe.capacity(4, cfg, factor=100.0) == 4  # never exceeds T


def test_served_capacities():
    """granite-moe at the served shapes: C = 2560 in an 8 x 1024 prefill,
    3 in an 8-row decode step."""
    cfg = get_config("granite_moe_1b_a400m")
    assert moe.capacity(8 * 1024, cfg) == 2560
    assert moe.capacity(8, cfg) == 3


# ------------------------------------------------------------- moe_fwd


@pytest.mark.parametrize("capacity_factor", [None, 1.0, 0.5], ids=["dropless", "cf1", "cf0.5"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_fwd_matches_reference(arch, capacity_factor):
    """The reduced config of each MoE arch, dropless and at capacity
    factors that drop assignments (at 24 tokens, top 2 of 4: C = 12 and 6)."""
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    assert cfg == ArchConfig(**dataclasses.asdict(jcfg))
    np_p, p = _params(cfg)
    x = _x(cfg, 2, 12)
    want = np.asarray(jmoe.moe_fwd(jax.tree.map(jnp.asarray, np_p), jnp.asarray(x), jcfg,
                                   capacity_factor=capacity_factor))
    got = moe.moe_fwd(p, torch.tensor(x), cfg, capacity_factor=capacity_factor)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    if capacity_factor is not None:
        c = moe.capacity(24, cfg, capacity_factor)
        _, _, rank, keep = moe.route(p["router"], torch.tensor(x).reshape(24, -1), cfg, c)
        assert not bool(keep.all()), "no assignment dropped"
        assert int(rank[keep].max()) == c - 1


def _moe_fwd_masked_dispatch(p, x, cfg, capacity_factor):
    """``moe_fwd`` as it dispatched before the static-shape form: the kept
    assignments picked by a boolean mask (a data-dependent shape) and put
    into an ``(E, C, d)`` buffer."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.num_experts, cfg.top_k
    c = moe.capacity(t, cfg, capacity_factor)
    xt = x.reshape(t, d)
    gates, flat_e, rank, keep = moe.route(p["router"], xt, cfg, c)
    xa = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    xe = xt.new_zeros((e, c, d))
    xe.index_put_((flat_e[keep], rank[keep]), xa[keep])
    h = torch.einsum("ecd,edf->ecf", xe, p["wi"])
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe, p["wg"])) * h \
        if cfg.act == "swiglu" else torch.nn.functional.gelu(h, approximate="tanh")
    ye = torch.einsum("ecf,efd->ecd", h, p["wo"])
    per_assign = ye[flat_e, rank.clamp(max=c - 1)] * (
        gates.reshape(-1, 1).to(ye.dtype) * keep[:, None])
    return per_assign.reshape(t, k, d).sum(dim=1).reshape(b, s, d)


@pytest.mark.parametrize("capacity_factor", [None, 1.0, 0.5], ids=["dropless", "cf1", "cf0.5"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_static_dispatch_bit_equal_to_the_masked_dispatch(arch, capacity_factor):
    """The sacrificial-slot dispatch gives the masked dispatch's bits,
    dropless and with drops, and traces on the ``meta`` device (no shape
    depends on the routing)."""
    cfg = get_config(arch).reduced()
    assert cfg.act == "swiglu"
    _, p = _params(cfg)
    x = torch.tensor(_x(cfg, 2, 12))
    got = moe.moe_fwd(p, x, cfg, capacity_factor=capacity_factor)
    assert torch.equal(got, _moe_fwd_masked_dispatch(p, x, cfg, capacity_factor))
    meta = moe.moe_fwd({k: v.to("meta") for k, v in p.items()}, x.to("meta"), cfg,
                       capacity_factor=capacity_factor)
    assert meta.device.type == "meta" and meta.shape == x.shape


def test_route_is_the_reference_routing():
    """The experts, slots and drops of every assignment equal the
    reference's (its top_k, its float32 exclusive count)."""
    cfg = _cfg(num_experts=8, top_k=3)
    np_p, p = _params(cfg)
    xt = _x(cfg, 1, 40)[0]
    c = moe.capacity(40, cfg, 0.75)
    gates, flat_e, rank, keep = moe.route(p["router"], torch.tensor(xt), cfg, c)
    scores = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(np_p["router"]), axis=-1)
    jg, je = jax.lax.top_k(scores, 3)
    onehot = jax.nn.one_hot(je.reshape(-1), 8, dtype=jnp.float32)
    jrank = np.asarray(jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1))
    np.testing.assert_array_equal(flat_e.numpy(), np.asarray(je).reshape(-1))
    np.testing.assert_array_equal(rank.numpy(), jrank.astype(np.int64))
    np.testing.assert_array_equal(keep.numpy(), jrank < c)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)


def test_ties_route_to_the_lower_expert():
    """Two identical router columns give every token equal scores for two
    experts: the lower index is taken first, as ``jax.lax.top_k`` takes it,
    and the outputs equal the reference's."""
    cfg = _cfg(num_experts=4, top_k=1)
    np_p, p = _params(cfg)
    np_p["router"][:, 1] += 10.0 * np.abs(np_p["router"]).max()   # 1 and 2 lead, equal
    np_p["router"][:, 2] = np_p["router"][:, 1]
    p["router"] = torch.tensor(np_p["router"])
    x = np.abs(_x(cfg, 1, 10))
    _, flat_e, _, _ = moe.route(p["router"], torch.tensor(x[0]), _cfg(num_experts=4, top_k=1),
                                10)
    jscores = jax.nn.softmax(jnp.asarray(x[0]) @ jnp.asarray(np_p["router"]), axis=-1)
    je = np.asarray(jax.lax.top_k(jscores, 1)[1]).reshape(-1)
    assert (je == 1).all()
    np.testing.assert_array_equal(flat_e.numpy(), je)
    want = np.asarray(jmoe.moe_fwd(jax.tree.map(jnp.asarray, np_p), jnp.asarray(x),
                                   _jcfg(cfg), capacity_factor=None))
    _close(moe.moe_fwd(p, torch.tensor(x), cfg, capacity_factor=None), want)


def test_identical_experts_match_dense_when_dropless():
    """top_k == E + dropless capacity: every token fully served by each
    (identical) expert; softmax gates sum to 1 => output == dense MLP."""
    cfg = _cfg(num_experts=2, top_k=2)
    _, p = _params(cfg)
    for k in ("wi", "wg", "wo"):
        p[k] = torch.stack([p[k][0]] * cfg.num_experts)
    x = torch.tensor(_x(cfg, 1, 8))
    y = moe.moe_fwd(p, x, cfg, capacity_factor=float(cfg.num_experts))
    dense = tlayers.mlp_fwd({"wi": p["wi"][0], "wg": p["wg"][0], "wo": p["wo"][0]}, x, cfg)
    torch.testing.assert_close(y, dense, rtol=1e-3, atol=1e-4)


def test_routing_is_causal_per_sequence():
    """Within a sequence, appending tokens must not change earlier
    positions' outputs even when capacity binds (equal C = 4 for both
    lengths, so only the order matters)."""
    cfg = _cfg(num_experts=4, top_k=1)
    _, p = _params(cfg)
    x = torch.tensor(_x(cfg, 1, 24, seed=2))
    y_long = moe.moe_fwd(p, x, cfg, capacity_factor=4 * 4 / 24)
    y_short = moe.moe_fwd(p, x[:, :14], cfg, capacity_factor=4 * 4 / 14)
    torch.testing.assert_close(y_short, y_long[:, :14], rtol=1e-4, atol=1e-5)


def test_position_priority_drops_later_tokens():
    """With capacity 1 per expert and one dominant expert, only the earliest
    position gets served."""
    cfg = _cfg(num_experts=2, top_k=1)
    _, p = _params(cfg)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][0, 0] = 100.0
    x = torch.ones((1, 4, cfg.d_model)) * 0.1
    y = moe.moe_fwd(p, x, cfg, capacity_factor=1e-9)  # C = 1
    served = y[0].abs().sum(dim=-1) > 1e-7
    assert bool(served[0]) and not bool(served[1:].any())


def test_moe_defs_are_the_reference_defs():
    for cfg in (_cfg(), _cfg(act="gelu"), get_config("dbrx_132b"),
                dataclasses.replace(get_config("granite_moe_1b_a400m").reduced(),
                                    psram_projections=True, psram_stored_int8=True)):
        got, want = moe.moe_defs(cfg), jmoe.moe_defs(_jcfg(cfg))
        assert jax.tree.map(lambda d: d, want) == got


# ---------------------------------------------------------- psram_einsum


@pytest.mark.parametrize("spec", ["ecd,edf->ecf", "ecf,efd->ecd"])
def test_psram_einsum_bit_equal_to_the_reference(spec):
    """The reference's own stored words (``init`` with
    ``psram_stored_int8``) carried over by ``convert``, the same activation:
    the port's f32 exact contraction gives the reference's integers, so
    the output is bit-equal to the reference run op by op."""
    jcfg = dataclasses.replace(jget_config("granite_moe_1b_a400m").reduced(),
                               psram_projections=True, psram_stored_int8=True)
    jparams = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jw = jax.tree.map(lambda a: a[0], jparams["blocks"]["layer0"]["mlp"])
    jw = jw["wi"] if spec.startswith("ecd") else jw["wo"]
    assert jw["q"].dtype == jnp.int8 and jw["scale"].shape == (1, 1, jw["q"].shape[-1])
    w = {k: convert._array_tensor(np.asarray(v), "cpu") for k, v in jw.items()}
    e, kdim = w["q"].shape[0], w["q"].shape[1]
    x = np.random.default_rng(3).standard_normal((e, 6, kdim)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jpl.psram_einsum(spec, jnp.asarray(x), jw, 16))
        want8 = np.asarray(jpl.psram_einsum(spec, jnp.asarray(x), jw, 8))
    got = tpl.psram_einsum(spec, torch.tensor(x), w)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpl.psram_einsum(spec, torch.tensor(x), w, 8).numpy(), want8)


def test_psram_einsum_is_psram_linear_per_expert():
    """Expert by expert, ``psram_einsum`` is ``psram_linear`` on that
    expert's words (kernel 2's plain version on the CPU), bit for bit — at
    K = 512 (float32 contraction) and K = 1100 (float64)."""
    rng = np.random.default_rng(5)
    for kdim in (512, 1100):
        w = {"q": torch.tensor(rng.integers(-127, 128, (3, kdim, 40)).astype(np.int8)),
             "scale": torch.tensor(rng.uniform(1e-3, 1e-2, (1, 1, 40)).astype(np.float32))}
        x = torch.tensor(rng.standard_normal((3, 7, kdim)).astype(np.float32))
        got = tpl.psram_einsum("ecd,edf->ecf", x, w)
        for i in range(3):
            want = tpl.psram_linear(x[i], {"q": w["q"][i], "scale": w["scale"][0]})
            assert torch.equal(got[i], want)


# --------------------------------------------------------------- serving


def test_serve_engine_serves_the_moe_family():
    """``ServeEngine`` serves reduced granite-moe unchanged: greedy tokens
    equal to the reference engine's on the reference's params."""
    jcfg = jget_config("granite_moe_1b_a400m").reduced()
    jparams = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    prompts = np.random.default_rng(11).integers(2, jcfg.vocab_size, (2, 8), dtype=np.int32)
    want = np.asarray(JServeEngine(jcfg, jparams, max_len=12).generate(
        jnp.asarray(prompts), 8, 4))
    cfg = get_config("granite_moe_1b_a400m").reduced()
    params = convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    got = ServeEngine(cfg, params, max_len=12, device="cpu").generate(
        torch.tensor(prompts), 8, 4)
    np.testing.assert_array_equal(got.numpy(), want)
