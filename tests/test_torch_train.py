"""The port's training path held against the JAX reference on the CPU.

* ``loss_fn`` and its gradients (``train.step.make_loss_fn``) at
  ``reduced()`` for five families — dense (granite-8b), MoE
  (granite-moe-1b-a400m), SSM (mamba2-370m), hybrid (jamba-1.5-large) and
  encoder-decoder (seamless-m4t-large-v2, with frames) — on the reference's
  params through ``convert``, the same numpy-seeded batch with padded
  labels: the loss within 1e-5 relative, each gradient leaf within 1e-4 of
  its own max |g| (f32 sums in another order, amplified through the SSD
  scan's exps; measured worst 2.9e-5, jamba).
* One whole ``make_train_step`` — plain, two microbatches, and error
  feedback — against the reference's jitted step, two steps from the same
  params and batches: loss, grad norm and lr within 1e-5 relative, params
  within 1e-6 of max |p| but for the elements where Adam's first update
  (about ``lr * sign(g)``) divides a gradient near its own tolerance, or an
  int8 code sits at a rounding boundary: those are counted (measured 1, 6
  and 4 of 106,816) and must stay under 1e-3 of the parameters, each within
  what a flipped update moves it, ``lr * (2 + weight decay * |p|)`` a step
  (measured worst 0.002, 0.011 and 0.042 lr).
* ``cfg.remat`` under both policies: gradients equal to those without.
* The reference's own training tests (``tests/test_train_infra.py``),
  mirrored: the loss decreases, microbatches match one batch, the factored
  optimizer trains, ``Trainer`` resumes exactly; a ``Trainer`` on a mesh
  over several cards and stored-int8 pSRAM training raise (the latter as
  the reference's ``jax.grad`` does); ``launch.train.main`` trains a
  reduced config on the CPU, with ``--model-parallel 1 --seq-shard`` equal
  to without.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_state as jinit_state
from repro.train.step import make_loss_fn as jmake_loss_fn
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch._tree import leaf_sets, leaves
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_config
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train import Trainer, init_train_state, make_loss_fn, make_train_step
from repro_torch.train.step import _value_and_grad

FAMILIES = ["granite_8b", "granite_moe_1b_a400m", "mamba2_370m", "jamba_1p5_large",
            "seamless_m4t_large_v2"]
B, S, ENC_FRAMES = 2, 16, 20


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(jcfg, seed=1, batch=B):
    """Tokens, next-token labels (the last three of row 0 padding) and, for
    the encoder-decoder, frames — numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (batch, S + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1
    out = {"tokens": toks[:, :-1], "labels": labels}
    if jcfg.family == "encdec":
        out["frames"] = rng.standard_normal((batch, ENC_FRAMES, jcfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _port_cfg(jcfg, **kw) -> ArchConfig:
    return dataclasses.replace(ArchConfig(**dataclasses.asdict(jcfg)), **kw)


def _pairs(got_tree, want_tree):
    """(path, got, want) for every per-group tensor of two port trees."""
    want = dict(leaf_sets(want_tree))
    for path, leaf in leaf_sets(got_tree):
        ws = want[path]
        for a, b in zip(leaf, ws) if isinstance(leaf, list) else [(leaf, ws)]:
            yield path, a, b


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    jcfg = jget_config(arch).reduced()
    params = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmake_loss_fn(jcfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = _port_cfg(jcfg)
    loss, grads = _value_and_grad(make_loss_fn(cfg),
                                  convert.model_params(_np(params), cfg, device="cpu"),
                                  _torch_batch(batch))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = convert.model_params(_np(jgrads), cfg, device="cpu")
    assert len(leaves(grads)) == len(leaves(want))
    for path, g, w in _pairs(grads, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert _rel_err(g, w) <= 1e-4, (path, _rel_err(g, w))


@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_370m"])
def test_remat_gradients_equal(arch):
    cfg = get_config(arch).reduced()
    params = init_train_state(0, cfg, device="cpu")[0]
    batch = _torch_batch(_batch(cfg))
    _, want = _value_and_grad(make_loss_fn(cfg), params, batch)
    for policy in ("dots", "nothing"):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        _, got = _value_and_grad(make_loss_fn(rcfg), params, batch)
        for path, g, w in _pairs(got, want):
            assert torch.equal(g, w), (policy, path)


@pytest.fixture(scope="module")
def psram_reference():
    """granite-8b reduced (f32) with pSRAM projections: the reference's
    params, a batch, and ``jax.grad`` of its ``loss_fn``."""
    jcfg = dataclasses.replace(jget_config("granite_8b").reduced(), psram_projections=True)
    params = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmake_loss_fn(jcfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return jcfg, params, batch, jloss, jgrads


@pytest.mark.parametrize("remat", ["off", "dots"])
def test_psram_gradients_match_reference(psram_reference, remat):
    """pSRAM projections' gradients flow through the scales only (each
    column's and row's max |.|), as ``jax.grad`` of the reference's: the
    nonzero pattern equal on every leaf, the values within 1e-5 of each
    leaf's max |g| (measured worst 5.2e-7, ``wq``: f32 sums in another
    order), with and without remat."""
    jcfg, params, batch, jloss, jgrads = psram_reference
    cfg = _port_cfg(jcfg, remat=remat != "off", remat_policy="dots")
    loss, grads = _value_and_grad(make_loss_fn(cfg),
                                  convert.model_params(_np(params), cfg, device="cpu"),
                                  _torch_batch(batch))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = convert.model_params(_np(jgrads), cfg, device="cpu")
    sparse = 0
    for path, g, w in _pairs(grads, want):
        assert torch.equal(g != 0, w != 0), path
        assert _rel_err(g, w) <= 1e-5, (path, _rel_err(g, w))
        if path[-1] in ("wq", "wk", "wv", "wo", "wi", "wg"):
            # a projection's weight: one nonzero a column, at its max |w|
            # (two where a column's max ties)
            sparse += 1
            assert int((w != 0).sum()) <= 2 * w.shape[-1], path
    assert sparse == 7 * jcfg.num_layers


def test_psram_train_step_matches_reference():
    """One pSRAM ``make_train_step`` against the reference's jitted step:
    loss, grad norm and lr within 1e-5 relative."""
    jcfg = dataclasses.replace(jget_config("granite_8b").reduced(), psram_projections=True)
    jparams = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=50)
    batch = _batch(jcfg, seed=10, batch=4)
    _, _, jm = jax.jit(jmake_train_step(jcfg, JAdamWConfig(**okw)))(
        jparams, jinit_state(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = _port_cfg(jcfg)
    params = convert.model_params(_np(jparams), cfg, device="cpu")
    _, _, m = make_train_step(cfg, AdamWConfig(**okw))(params, init_state(params),
                                                       _torch_batch(batch))
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key


STEP_CASES = {
    "plain": {},
    "microbatches_2": {"microbatches": 2},
    "error_feedback": {"compress_grads": True, "error_feedback": True},
}


@pytest.fixture(scope="module")
def granite_reference():
    jcfg = jget_config("granite_8b").reduced()
    params = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(granite_reference, case):
    jcfg, jparams = granite_reference
    kw = STEP_CASES[case]
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=50)
    ef = kw.get("error_feedback", False)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(**okw), **kw))
    cfg = _port_cfg(jcfg)
    step = make_train_step(cfg, AdamWConfig(**okw), **kw)
    jopt = jinit_state(jparams)
    params = convert.model_params(_np(jparams), cfg, device="cpu")
    opt = init_state(params)
    if ef:
        jres = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
        res = convert.model_params(_np(jres), cfg, device="cpu")
    for i in range(2):
        batch = _batch(jcfg, seed=10 + i, batch=4)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if ef:
            jparams, jopt, jm, jres = jstep(jparams, jopt, jb, jres)
            params, opt, m, res = step(params, opt, _torch_batch(batch), res)
        else:
            jparams, jopt, jm = jstep(jparams, jopt, jb)
            params, opt, m = step(params, opt, _torch_batch(batch))
        for key in ("loss", "grad_norm", "lr"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
    want = convert.model_params(_np(jparams), cfg, device="cpu")
    n = far = 0
    worst = 0.0
    for path, p, w in _pairs(params, want):
        top = float(w.abs().max())
        d = (p - w).abs()
        far += int((d > 1e-6 * top).sum())
        n += w.numel()
        # a flipped or shrunk first update moves an element by at most
        # lr * (2 + weight decay * |p|) per step
        worst = max(worst, float(d.max()) / okw["lr"])
    assert worst <= 2 * (2 + 0.1 * 4), worst
    assert far <= 1e-3 * n, (far, n)


def test_loss_decreases():
    cfg = get_config("granite_8b").reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60))
    params, opt = init_train_state(0, cfg, device="cpu")
    losses = []
    for i in range(40):
        t, lab = batch_at_step(dc, i, device="cpu")
        params, opt, m = step(params, opt, {"tokens": t, "labels": lab})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_grad_accum_equivalent():
    """microbatches=2 must match microbatches=1 on the same global batch."""
    cfg = get_config("granite_8b").reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    oc = AdamWConfig(lr=1e-3)
    t, lab = batch_at_step(dc, 0, device="cpu")
    out = []
    for mb in (1, 2):
        p0, o0 = init_train_state(0, cfg, device="cpu")
        out.append(make_train_step(cfg, oc, microbatches=mb)(p0, o0, {"tokens": t, "labels": lab}))
    (p1, _, m1), (p2, _, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2e-2, atol=2e-4)


def test_factored_optimizer_memory_and_convergence():
    """bf16-m + factored-v AdamW: state is smaller and still trains."""
    from repro_torch.optim import state_structs
    cfg = get_config("granite_8b").reduced()
    oc = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60, m_dtype="bfloat16",
                     factored_v=True)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    step = make_train_step(cfg, oc)
    params, opt = init_train_state(0, cfg, oc, device="cpu")
    # factored v of a (d, ff) weight stores d + ff floats, not d*ff
    wi = opt["v"]["blocks"]["layer0"]["mlp"]["wi"]
    assert isinstance(wi, dict) and set(wi) == {"row", "col"}
    losses = []
    for i in range(30):
        t, lab = batch_at_step(dc, i, device="cpu")
        params, opt, m = step(params, opt, {"tokens": t, "labels": lab})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, t in leaf_sets(tree))

    full, small = state_structs(params, AdamWConfig()), state_structs(params, oc)
    assert nbytes(small) < 0.7 * nbytes(full)


def test_trainer_resume_exact(tmp_path):
    cfg = get_config("granite_8b").reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    t1 = Trainer(cfg, dc, ckpt_dir=str(tmp_path), ckpt_every=5, opt_cfg=AdamWConfig(lr=1e-3),
                 device="cpu")
    t1.run(10, log_every=100, log_fn=lambda *_: None)
    t2 = Trainer(cfg, dc, ckpt_dir=str(tmp_path), opt_cfg=AdamWConfig(lr=1e-3), device="cpu")
    assert t2.start_step == 10
    for a, b in zip(leaves(t1.params), leaves(t2.params)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(t1.opt_state), leaves(t2.opt_state)):
        assert torch.equal(a, b)
    # the resumed run goes on exactly as one run of 13 steps
    t2.run(3, log_every=100, log_fn=lambda *_: None)
    t3 = Trainer(cfg, dc, opt_cfg=AdamWConfig(lr=1e-3), device="cpu")
    t3.run(13, log_every=100, log_fn=lambda *_: None)
    for a, b in zip(leaves(t3.params), leaves(t2.params)):
        assert torch.equal(a, b)


def test_trainer_error_feedback_resumes_its_residual(tmp_path):
    cfg = get_config("granite_8b").reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    kw = dict(ckpt_dir=str(tmp_path), opt_cfg=AdamWConfig(lr=1e-3), error_feedback=True,
              device="cpu")
    t1 = Trainer(cfg, dc, **kw)
    t1.run(3, log_every=100, log_fn=lambda *_: None)
    assert any(float(r.abs().max()) > 0 for r in leaves(t1.residual))
    t2 = Trainer(cfg, dc, **kw)
    assert t2.start_step == 3
    for a, b in zip(leaves(t1.residual), leaves(t2.residual)):
        assert torch.equal(a, b)


def test_trainer_on_a_host_mesh_equals_trainer():
    """``Trainer(mesh=make_host_mesh(device="cpu"), sharding_rules=)``: the
    steps run under ``use_sharding`` (every hint computes its spec) and
    change no bit of the losses or the params."""
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config("granite_moe_1b_a400m").reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    kw = dict(opt_cfg=AdamWConfig(lr=1e-3), microbatches=2)
    mesh = Trainer(cfg, dc, mesh=make_host_mesh(device="cpu"),
                   sharding_rules={"seq": (("model",), ())}, **kw)
    plain = Trainer(cfg, dc, device="cpu", **kw)
    assert mesh.device == torch.device("cpu")
    quiet = dict(log_every=100, log_fn=lambda *_: None)
    assert mesh.run(3, **quiet) == plain.run(3, **quiet)
    for a, b in zip(leaves(mesh.params), leaves(plain.params)):
        assert torch.equal(a, b)


def test_mesh_and_psram_training_raise():
    """A mesh over several cards, or a logical one, and stored-int8 pSRAM
    training raise; the reference's jax.grad refuses int8 leaves too."""
    from repro_torch.launch.mesh import ModelMesh, make_production_mesh
    cfg = get_config("granite_8b").reduced()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    two = ModelMesh(("data", "model"), (1, 2), ("cuda:0", "cuda:1"))
    with pytest.raises(RuntimeError, match="one process a card"):
        Trainer(cfg, dc, mesh=two)
    with pytest.raises(ValueError, match="logical"):
        Trainer(cfg, dc, mesh=make_production_mesh())
    icfg = dataclasses.replace(cfg, psram_projections=True, psram_stored_int8=True)
    with pytest.raises(TypeError, match=r"int8 leaves.*\['wq'\]/\['q'\]"):
        make_train_step(icfg, AdamWConfig())
    jcfg = jget_config("granite_8b").reduced()
    jcfg = dataclasses.replace(jcfg, psram_projections=True, psram_stored_int8=True)
    from repro.train.step import init_train_state as jinit_train_state
    jparams, jopt = jinit_train_state(jax.random.PRNGKey(0), jcfg)
    tokens = jnp.zeros((2, 8), jnp.int32)
    with pytest.raises(TypeError, match="int8"):
        jmake_train_step(jcfg, JAdamWConfig())(jparams, jopt, {"tokens": tokens,
                                                               "labels": tokens})


def test_launch_train_runs_reduced_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    history = train.main(["--arch", "granite_8b", "--reduced", "--device", "cpu", "--steps", "4",
                          "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                          "--error-feedback"])
    assert len(history) == 4 and all(np.isfinite(history))
    assert "final loss" in capsys.readouterr().out
    assert (tmp_path / "step_000000004" / "done").exists()
    mp = train.main(["--arch", "granite_8b", "--reduced", "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "16", "--model-parallel", "1", "--seq-shard"])
    plain = train.main(["--arch", "granite_8b", "--reduced", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "16"])
    assert mp == plain
    # --distributed joins the group torchrun's variables describe: here a
    # world of one gloo rank, whose 1 x 1 mesh holds DTensors
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dd = train.main(["--arch", "granite_8b", "--reduced", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--distributed"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    np.testing.assert_allclose(dd, plain, rtol=1e-6)
