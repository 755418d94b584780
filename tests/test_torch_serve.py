"""The port's serving engine held against the JAX reference on the CPU.

Reduced (f32) granite-8b (and mamba2, jamba: the SSM and hybrid families;
the encoder-decoder's engine is in ``test_torch_encdec.py``) with the
reference's own params carried over by ``convert.model_params``; the same
numpy-seeded prompts go through the reference's ``ServeEngine`` and the
port's. Greedy tokens must be equal; the
prefill logits within 1e-5 of max |logit| (f32 matmuls, sums in another
order). Temperature sampling cannot give JAX's bits and is not compared.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro.serve import ServeEngine as JServeEngine
from repro.serve import make_prefill as jmake_prefill
from repro_torch import convert
from repro_torch.models.config import ArchConfig
from repro_torch.serve import ServeEngine, make_prefill, make_serve_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, PROMPT, NEW = 2, 8, 4


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("granite_8b").reduced()
    params = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    prompts = np.random.default_rng(11).integers(2, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    eng = JServeEngine(jcfg, params, max_len=PROMPT + NEW)
    toks = np.asarray(eng.generate(jnp.asarray(prompts), PROMPT, NEW))
    logits, _ = jmake_prefill(jcfg, PROMPT + NEW)(params, jnp.asarray(prompts))
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    port_params = convert.model_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, port_params, prompts, toks, np.asarray(logits)


def test_greedy_tokens_equal_reference(served):
    cfg, params, prompts, want, _ = served
    eng = ServeEngine(cfg, params, max_len=PROMPT + NEW, device="cpu")
    got = eng.generate(torch.tensor(prompts), PROMPT, NEW)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_logits_match_reference(served):
    cfg, params, prompts, _, want = served
    logits, cache = make_prefill(cfg, PROMPT + NEW)(params, torch.tensor(prompts))
    assert float((logits.numpy() - want).__abs__().max()) <= 1e-5 * float(np.abs(want).max())
    assert len(cache) == cfg.num_groups
    assert tuple(cache[0]["layer0"]["k"].shape) == (B, PROMPT + NEW, cfg.n_kv_heads, cfg.head_dim)


def test_serve_step_deltas_leave_the_cache(served):
    """``deltas=True`` returns the new token's k/v and writes nothing; the
    plain step writes exactly those deltas at ``cache_pos``."""
    cfg, params, prompts, _, _ = served
    logits, cache = make_prefill(cfg, PROMPT + NEW)(params, torch.tensor(prompts))
    tok = logits.argmax(-1).to(torch.int32)
    before = cache[0]["layer0"]["k"].clone()
    lg_d, deltas = make_serve_step(cfg, deltas=True)(params, cache, tok, PROMPT)
    assert torch.equal(cache[0]["layer0"]["k"], before)
    lg, cache = make_serve_step(cfg)(params, cache, tok, PROMPT)
    assert torch.equal(lg, lg_d)
    assert torch.equal(cache[0]["layer0"]["k"][:, PROMPT:PROMPT + 1], deltas[0]["layer0"]["k"])
    # the paged prefill (the serve loop's) runs; its parity tests are in
    # test_torch_serve_loop.py
    lg_p, caches = make_prefill(cfg, paged=True)(params, torch.tensor(prompts), PROMPT - 1)
    torch.testing.assert_close(lg_p, logits, rtol=1e-6, atol=1e-6 * float(logits.abs().max()))
    assert torch.equal(caches[0]["layer0"]["k"], cache[0]["layer0"]["k"][:, :PROMPT])


@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_1p5_large"])
def test_greedy_tokens_equal_reference_ssm_families(arch):
    """SSM decode steps (the recurrent state replaced each step) and the
    hybrid's one attention layer a group, through both engines."""
    jcfg = jget_config(arch).reduced()
    params = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    prompts = np.random.default_rng(12).integers(2, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    want = np.asarray(JServeEngine(jcfg, params, max_len=PROMPT + NEW)
                      .generate(jnp.asarray(prompts), PROMPT, NEW))
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    port_params = convert.model_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    got = ServeEngine(cfg, port_params, max_len=PROMPT + NEW, device="cpu").generate(
        torch.tensor(prompts), PROMPT, NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_1b_a400m"])
def test_serve_engine_on_a_host_mesh(arch, capsys):
    """``ServeEngine(mesh=make_host_mesh(device="cpu"), sharding_rules=)``:
    every model hint computes its spec on the one-device mesh and changes
    no bit — greedy tokens equal to ``mesh=None`` and to the reference's
    engine on its host mesh; the serve CLI's ``--model-parallel 1`` runs."""
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    rules = {"seq": (("model",), ())}
    jcfg = jget_config(arch).reduced()
    params = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    prompts = np.random.default_rng(13).integers(2, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    want = np.asarray(JServeEngine(jcfg, params, max_len=PROMPT + NEW, mesh=jmake_host_mesh(),
                                   sharding_rules=rules).generate(jnp.asarray(prompts), PROMPT,
                                                                  NEW))
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    port_params = convert.model_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    eng = ServeEngine(cfg, port_params, max_len=PROMPT + NEW,
                      mesh=make_host_mesh(device="cpu"), sharding_rules=rules)
    assert eng.device == torch.device("cpu")
    got = eng.generate(torch.tensor(prompts), PROMPT, NEW)
    plain = ServeEngine(cfg, port_params, max_len=PROMPT + NEW, device="cpu").generate(
        torch.tensor(prompts), PROMPT, NEW)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), want)
    if arch == "granite_8b":
        serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--max-new", "4", "--model-parallel", "1"])
        assert "generated (2, 4)" in capsys.readouterr().out


def test_temperature_sampling_is_seeded(served):
    cfg, params, prompts, _, _ = served
    eng = ServeEngine(cfg, params, max_len=PROMPT + NEW, device="cpu")
    runs = [eng.generate(torch.tensor(prompts), PROMPT, NEW, temperature=0.8,
                         generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


def _serve_cli(arch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--reduced",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--max-new", "4"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated (2, 4)" in proc.stdout and "on cpu" in proc.stdout


def test_serve_cli_on_the_cpu():
    _serve_cli("granite_8b")


def test_serve_cli_encdec_draws_frames():
    """The encoder-decoder through the CLI: it draws the encoder's stub
    frames, (batch, 4 * prompt_len, d_model), from a seeded generator."""
    _serve_cli("seamless_m4t_large_v2")
