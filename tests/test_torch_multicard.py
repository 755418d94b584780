"""Placement across several ranks, held against one process and the JAX
reference on the CPU: four gloo ranks, spawned once for the module.

The ranks meet through a ``file://`` store under ``tmp_path`` (no TCP port
for the mesh work, so xdist workers cannot clash) and run, on the
``(1, 4)`` and ``(2, 2)`` host meshes, reduced (f32) granite-8b and
granite-moe-1b-a400m (its experts sharded over ``"model"``) with the
reference's own params (``convert.model_params``):

* the forward's logits within 1e-5 of max |logit| of the port in one
  process, exact and with pSRAM projections;
* kernel 2's plain version behind a column-parallel (q) and a row-parallel
  (o: K split, the row and column maxima and the ADC's full scale over the
  whole K, the int32 sums all-reduced) projection **equal** to one process,
  programmed on the fly and from stored int8 words, and with
  ``saturate=False`` on a planted full-scale row and column (the unclipped
  code one past the rail);
* ``ServeEngine(mesh=)``'s greedy tokens equal to the reference's engine;
* 3 ``Trainer`` steps on ``(2, 2)`` with FSDP: losses and params within
  1e-5 relative of one process;
* a checkpoint written by the 4 ranks restored in one process bit-equal to
  the ranks' params, and one written by one process restored on the ranks;
* ``launch.train --distributed`` under torchrun's environment variables,
  in a second spawn (it joins through ``MASTER_ADDR`` / ``MASTER_PORT``, a
  port the OS hands out).

The JAX side is imported in the parent only; the spawned ranks import
torch and the port.
"""
import dataclasses
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

ARCHS = ("granite_8b", "granite_moe_1b_a400m")
MESHES = (4, 2)             # the model axis: (1, 4) and (2, 2)
B, PROMPT, NEW = 4, 8, 4
WORLD = 4
STEPS = 3


def _quiet():
    return dict(log_every=100, log_fn=lambda *_: None)


def _train_setup(cfg):
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    return (DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4),
            dict(opt_cfg=AdamWConfig(lr=1e-3)))


def _launch_argv(ckpt):
    return ["--arch", "granite_8b", "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--ckpt-dir", ckpt]


def _projections(cfg, params, x_q, x_o):
    """Layer 0's q (column-parallel) and o (row-parallel) projections
    through kernel 2's plain version: programmed on the fly and from stored
    words; on a mesh each placed by its spec."""
    from repro_torch.core.photonic_layer import program_weights, psram_linear
    from repro_torch.models.layers import _proj
    pcfg = dataclasses.replace(cfg, psram_projections=True)
    mixer = params["blocks"][0]["layer0"]["mixer"]
    out = {"q": _proj(x_q, mixer["wq"], pcfg), "o": _proj(x_o, mixer["wo"], pcfg)}
    for name, x, w in (("q_words", x_q, mixer["wq"]), ("o_words", x_o, mixer["wo"])):
        out[name] = psram_linear(x, program_weights(w), adc_bits=cfg.adc_bits)
    return out


def _planted(x, w, seed):
    """``x`` (..., K) and ``w`` (K, N) with the first row of ``x`` at its
    absolute maximum everywhere and column 1 of ``w`` at one magnitude, their
    signs matched: that row and column accumulate the ADC's full scale."""
    x, w = x.clone(), w.clone()
    signs = torch.tensor(np.where(np.random.default_rng(seed).random(w.shape[0]) < 0.5,
                                  -1.0, 1.0), dtype=torch.float32)
    x.reshape(-1, x.shape[-1])[0] = 0.75 * signs
    w[:, 1] = 0.125 * signs
    return x, w


def _unsaturated(cfg, planted, place=None):
    """``psram_linear(saturate=False)`` behind q (column-parallel) and o
    (row-parallel, the K split) on the planted operands, placed by
    ``place(tensor, logical axes)`` where given."""
    from repro_torch.core.photonic_layer import program_weights, psram_linear
    out = {}
    for name, (x, w, axes) in planted.items():
        if place is not None:
            x, w = place(x, ("batch", "seq", None)), place(w, axes)
        out[name] = psram_linear(x, program_weights(w), adc_bits=cfg.adc_bits, saturate=False)
    return out


def _worker(rank, tmp):
    """One rank: every case on both meshes; rank 0 saves the results."""
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch._tree import leaves, tree_map
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist.compression import compress_int8
    from repro_torch.dist.placement import distribute, distribute_tree, full
    from repro_torch.dist.sharding import logical_to_spec, use_sharding
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine
    from repro_torch.train import Trainer

    init_distributed("cpu", init_method=f"file://{tmp}/store", rank=rank, world_size=WORLD)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    out = {}
    for model in MESHES:
        mesh = make_host_mesh(model=model, device="cpu")
        for arch in ARCHS:
            cfg, params, prompts = inp[arch]["cfg"], inp[arch]["params"], inp[arch]["prompts"]
            placed = distribute_tree(params, transformer.param_specs(cfg), mesh)
            # the reference's numpy leaves placed straight onto the mesh
            conv = convert.model_params(inp[arch]["numpy"], cfg, mesh=mesh)
            out[arch, model, "convert_equal"] = all(
                torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
                for a, b in zip(leaves(conv), leaves(placed)))
            g = inp[arch]["x_o"]
            q, scale = compress_int8(distribute(g, mesh, logical_to_spec(
                ("batch", "seq", "qdim"), g.shape, mesh)))
            out[arch, model, "compress"] = (full(q), scale.full_tensor())
            tokens = distribute(prompts, mesh, logical_to_spec(("batch", "seq"), prompts.shape,
                                                               mesh))
            pcfg = dataclasses.replace(cfg, psram_projections=True)
            with torch.no_grad(), use_sharding(mesh):
                out[arch, model, "logits"] = full(transformer.forward(placed, tokens, cfg))
                out[arch, model, "psram_logits"] = full(transformer.forward(placed, tokens, pcfg))
                x_q, x_o = inp[arch]["x_q"], inp[arch]["x_o"]
                spec = logical_to_spec(("batch", "seq", None), x_q.shape, mesh)
                got = _projections(cfg, placed, distribute(x_q, mesh, spec),
                                   distribute(x_o, mesh, spec))
            out[arch, model, "proj"] = {k: full(v) for k, v in got.items()}
            with torch.no_grad():
                got = _unsaturated(cfg, inp[arch]["planted"], lambda t, axes: distribute(
                    t, mesh, logical_to_spec(axes, t.shape, mesh)))
            out[arch, model, "unsaturated"] = {k: full(v) for k, v in got.items()}
            eng = ServeEngine(cfg, params, max_len=PROMPT + NEW, mesh=mesh)
            out[arch, model, "tokens"] = eng.generate(prompts, PROMPT, NEW)

    cfg = inp["granite_8b"]["cfg"]
    dc, kw = _train_setup(cfg)
    mesh = make_host_mesh(model=2, device="cpu")
    tr = Trainer(cfg, dc, mesh=mesh, fsdp=True, ckpt_dir=os.path.join(tmp, "ck4"), **kw)
    out["train_losses"] = tr.run(STEPS, **_quiet())
    out["train_params"] = tree_map(full, tr.params)
    out["train_placements"] = str(tr.params["blocks"][0]["layer0"]["mixer"]["wq"].placements)
    got, step = CheckpointManager(os.path.join(tmp, "ck1")).restore({"params": tr.params})
    out["restored_step"] = step
    out["restored"] = tree_map(full, got["params"])
    out["restored_placements"] = str(got["params"]["blocks"][0]["layer0"]["mixer"]["wq"]
                                     .placements)

    if rank == 0:
        torch.save(out, os.path.join(tmp, "out.pt"))
    dist.destroy_process_group()


def _launcher(rank, tmp, port):
    """One rank of ``launch.train --distributed``, joined the way torchrun
    joins it (a second spawn: a process keeps one group)."""
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from repro_torch.launch import train
    history = train.main(_launch_argv(os.path.join(tmp, "ck_launch"))
                         + ["--distributed", "--model-parallel", "2"])
    if rank == 0:
        torch.save(history, os.path.join(tmp, "launch.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.models.registry import get_config as jget_config
    from repro.models.registry import get_module as jget_module
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.photonic_layer import program_weights, psram_linear
    from repro_torch.models import transformer
    from repro_torch.models.config import ArchConfig
    from repro_torch.train import Trainer

    tmp = str(tmp_path_factory.mktemp("multicard"))
    inp, ref = {}, {}
    rng = np.random.default_rng(7)
    for arch in ARCHS:
        jcfg = jget_config(arch).reduced()
        jparams = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
        prompts = rng.integers(2, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
        toks = np.asarray(JServeEngine(jcfg, jparams, max_len=PROMPT + NEW).generate(
            jnp.asarray(prompts), PROMPT, NEW))
        cfg = ArchConfig(**dataclasses.asdict(jcfg))
        params = convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        x_q = torch.tensor(rng.standard_normal((B, PROMPT, cfg.d_model)), dtype=torch.float32)
        x_o = torch.tensor(rng.standard_normal((B, PROMPT, cfg.q_dim)), dtype=torch.float32)
        mixer = params["blocks"][0]["layer0"]["mixer"]
        planted = {"q": (*_planted(x_q, mixer["wq"], 11), ("embed", "qdim")),
                   "o": (*_planted(x_o, mixer["wo"], 12), ("qdim", "embed"))}
        inp[arch] = dict(cfg=cfg, params=params, prompts=torch.tensor(prompts), x_q=x_q,
                         x_o=x_o, numpy=jax.tree.map(np.asarray, jparams), planted=planted)
        pcfg = dataclasses.replace(cfg, psram_projections=True)
        with torch.no_grad():
            ref[arch] = dict(
                tokens=toks,
                logits=transformer.forward(params, torch.tensor(prompts), cfg),
                psram_logits=transformer.forward(params, torch.tensor(prompts), pcfg),
                proj=_projections(cfg, params, x_q, x_o),
                unsaturated=_unsaturated(cfg, planted), saturated={
                    name: psram_linear(x, program_weights(w), adc_bits=cfg.adc_bits)
                    for name, (x, w, _) in planted.items()})
    torch.save(inp, os.path.join(tmp, "inputs.pt"))

    cfg = inp["granite_8b"]["cfg"]
    dc, kw = _train_setup(cfg)
    one = Trainer(cfg, dc, device="cpu", **kw)
    ref["train_losses"] = one.run(STEPS, **_quiet())
    ref["train_params"] = one.params
    CheckpointManager(os.path.join(tmp, "ck1")).save(7, {"params": one.params}, blocking=True)
    from repro_torch.launch import train
    ref["launch"] = train.main(_launch_argv(os.path.join(tmp, "ck_launch_1")))

    mp.spawn(_worker, args=(tmp,), nprocs=WORLD, join=True)
    mp.spawn(_launcher, args=(tmp, _free_port()), nprocs=WORLD, join=True)
    out = torch.load(os.path.join(tmp, "out.pt"), weights_only=False)
    out["launch"] = torch.load(os.path.join(tmp, "launch.pt"))
    return inp, ref, out, tmp


CASES = [(a, m) for m in MESHES for a in ARCHS]
IDS = [f"{a}-1x{m}" if m == 4 else f"{a}-2x2" for a, m in CASES]


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
@pytest.mark.parametrize("which", ["logits", "psram_logits"])
def test_logits_match_one_process(runs, arch, model, which):
    _, ref, out, _ = runs
    want, got = ref[arch][which], out[arch, model, which]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_psram_projections_equal_one_process(runs, arch, model):
    """Column- and row-parallel kernel 2 (plain version), on the fly and
    from stored words: the same bits as one process."""
    _, ref, out, _ = runs
    for name, want in ref[arch]["proj"].items():
        assert torch.equal(out[arch, model, "proj"][name], want), name


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_psram_unsaturated_placed_equals_one_process(runs, arch, model):
    """``psram_linear(saturate=False)`` on placed weights, column-parallel
    (q) and through the K split (o), on the planted full-scale row: the
    same bits as one process, which differ from ``saturate=True`` at the
    planted element alone (the unclipped code, one LSB past the rail)."""
    _, ref, out, _ = runs
    for name, want in ref[arch]["unsaturated"].items():
        assert torch.equal(out[arch, model, "unsaturated"][name], want), name
        differ = (want != ref[arch]["saturated"][name]).reshape(-1, want.shape[-1])
        assert differ.nonzero().tolist() == [[0, 1]], name


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_convert_places_reference_params(runs, arch, model):
    """``convert.model_params(..., mesh=)`` gives each rank the block
    ``distribute_tree`` gives it, placed alike."""
    _, _, out, _ = runs
    assert out[arch, model, "convert_equal"]


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_int8_compression_scale_spans_the_global_tensor(runs, arch, model):
    """The per-tensor scale of ``compress_int8`` on a placed gradient is the
    whole tensor's (a MAX across the blocks), the codes one process's."""
    from repro_torch.dist.compression import compress_int8
    inp, _, out, _ = runs
    q, scale = out[arch, model, "compress"]
    want_q, want_scale = compress_int8(inp[arch]["x_o"])
    assert torch.equal(q, want_q) and torch.equal(scale, want_scale)


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_greedy_tokens_equal_reference(runs, arch, model):
    _, ref, out, _ = runs
    got = out[arch, model, "tokens"]
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), ref[arch]["tokens"])


def test_fsdp_training_matches_one_process(runs):
    from repro_torch._tree import leaves
    _, ref, out, _ = runs
    np.testing.assert_allclose(out["train_losses"], ref["train_losses"], rtol=1e-5)
    for got, want in zip(leaves(out["train_params"]), leaves(ref["train_params"])):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max().clamp_min(1e-30))
    # FSDP on (2, 2): wq's embed dim over "data", its qdim over "model"
    assert out["train_placements"] == "(Shard(dim=0), Shard(dim=1))"


def test_checkpoint_from_four_ranks_restores_in_one_process(runs):
    from repro_torch._tree import leaves
    from repro_torch.checkpoint import CheckpointManager
    inp, _, out, tmp = runs
    like = {"params": out["train_params"]}
    got, step = CheckpointManager(os.path.join(tmp, "ck4")).restore(like)
    assert step == STEPS
    for a, b in zip(leaves(got["params"]), leaves(out["train_params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_from_one_process_restores_on_four_ranks(runs):
    from repro_torch._tree import leaves
    _, ref, out, _ = runs
    assert out["restored_step"] == 7
    assert out["restored_placements"] == "(Shard(dim=0), Shard(dim=1))"
    for a, b in zip(leaves(out["restored"]), leaves(ref["train_params"])):
        assert torch.equal(a, b)


def test_launch_train_distributed(runs):
    """``--distributed`` under torchrun's variables trains on a (2, 2) mesh
    and writes its checkpoint once; the losses are one process's."""
    _, ref, out, tmp = runs
    assert len(out["launch"]) == 2 and np.all(np.isfinite(out["launch"]))
    np.testing.assert_allclose(out["launch"], ref["launch"], rtol=1e-5)
    assert os.path.exists(os.path.join(tmp, "ck_launch", "step_000000002", "done"))
