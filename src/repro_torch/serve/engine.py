"""Serving engine: batched prefill + decode with a static KV cache.

`ServeEngine` handles a batch of requests end to end on the card (or the
CPU when asked): right-padded prompts (and, for the encoder-decoder family,
their frames), one prefill, then one decode step a token with greedy or
temperature sampling. `make_serve_step` builds the bare decode step (one
new token against a ``max_len`` cache); `make_prefill` the dense prefill,
and with ``paged=True`` the paged serve loop's.

`offload_report` prices offloading a workload onto the pSRAM engine through
the backend registry (`repro_torch.api.estimate`): a decode step's
projections (pass an ArchConfig), a dense MTTKRP descriptor, or a sparse
fiber-length distribution (nnz-balanced multi-array splits included) —
counted compute/write cycles, utilization from the counts, §III-B
energies, and (for projections) the end-to-end fidelity of the selected
backend. The pre-registry `photonic_offload_report` /
`sparse_offload_report` adapters are gone; asking for them raises a pointed
AttributeError naming the replacement.

PyTorch runs eagerly, so there is no compile step to wrap; the engine runs
under ``torch.inference_mode``. The KV cache is written in place. The live
request loop lives in `repro_torch.serve.loop`; it builds on
`make_prefill(cfg, paged=True)` / `make_serve_step(cfg, deltas=True)`.

``ServeEngine(mesh=, sharding_rules=)`` runs its prefill and decode under
``dist.sharding.use_sharding``, so the models' hints compute their specs;
on a mesh of one device without a process group that changes no bit. On a
mesh under a process group (one process a card; one rank included) the
engine places the params by ``param_specs`` and the cache by
``cache_specs`` as DTensors, the prompts by their batch spec, and hands
back tokens replicated on every rank. A port of ``repro.serve.engine``
whole.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import numpy as np
import torch

from repro_torch._device import as_device, ieee_f32
from repro_torch.dist.sharding import mesh_device, use_sharding
from repro_torch.models.registry import get_module


def _decode_projection_shapes(cfg, batch: int) -> list[tuple[int, int, int]]:
    """The dominant projection matmuls one decode step issues.

    Non-encdec families derive the per-layer mixer/MLP placement from
    ``models.blocks.group_layout`` — the same layout the model actually
    builds — so MoE layers are billed at the *active* expert width
    (top_k x d_ff_expert) exactly where the router runs and SSM layers bill
    their in/out projections instead of qkv. Approximation boundaries:
    router/conv/norm matvecs and the SSM state update are excluded (they are
    not §IV array-shaped matmuls); encoder layers never run at decode, and
    cross-attention reuses cached encoder k/v (only its q and output
    projections are billed).
    """
    from repro_torch.models.blocks import group_layout

    gated = 2 if cfg.act in ("swiglu", "geglu") else 1
    attn = [
        (batch, cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim),        # fused qkv
        (batch, cfg.q_dim, cfg.d_model),                         # output proj
    ]
    cross_attn = [
        (batch, cfg.d_model, cfg.q_dim),                         # q only
        (batch, cfg.q_dim, cfg.d_model),
    ]

    def mlp(ff):
        return [(batch, cfg.d_model, ff * gated), (batch, ff, cfg.d_model)]

    moe_ff = max(1, cfg.top_k) * (cfg.d_ff_expert or cfg.d_ff)
    d_in = cfg.d_inner_resolved
    ssm = [(batch, cfg.d_model, 2 * d_in), (batch, d_in, cfg.d_model)]

    shapes: list[tuple[int, int, int]] = []
    if cfg.family == "encdec":
        for _ in range(cfg.dec_layers or cfg.num_layers):
            shapes += attn + cross_attn + mlp(cfg.d_ff)
    else:
        for _ in range(cfg.num_groups):
            for desc in group_layout(cfg):
                shapes += attn if desc.mixer == "attn" else ssm
                if desc.mlp == "moe":
                    shapes += mlp(moe_ff)
                elif desc.mlp == "dense":
                    shapes += mlp(cfg.d_ff)
    shapes.append((batch, cfg.d_model, cfg.padded_vocab))            # unembed
    return shapes


def offload_report(workload, backend=None, config=None, *, batch: int = 1,
                   fidelity: bool = True, rank: int = 32, n_arrays: int = 1,
                   fabric=None, device="cuda"):
    """Cost of offloading ``workload`` onto the pSRAM engine, via the
    backend registry (built on ``repro_torch.api.estimate``).

    ``workload`` dispatches by type:

    * an ``ArchConfig`` — one decode step's projection matmuls
      (family-aware, see :func:`_decode_projection_shapes`), each priced as
      a ``MatmulWorkload`` with the IR's ``repeats`` folding identical
      layers. With ``fidelity=True`` one representative projection actually
      runs on the selected backend, on ``device``, to report the end-to-end
      relative error of its transfer function (skipped when the backend
      can't execute).
    * a ``SparseMTTKRPWorkload`` or a raw fiber-length array — the
      nonzero-streaming schedule, cross-checked against the analytical
      model (``model`` key); ``n_arrays > 1`` prices a makespan-planned
      multi-array split: execution = slowest array, then ``fabric`` (a
      ``perf_model.MeshFabric``, default electrical ring) all-reduces the
      partial outputs — the report gains ``makespan_cycles`` /
      ``reduce_cycles`` / ``n_arrays`` keys. A ``MeshSparseMTTKRPWorkload``
      carries its own topology, which wins over the keyword arguments.
    * a dense ``MTTKRPWorkload`` — the §V dense mapping.

    ``backend`` is a registry name (default: ``"psram-scheduled"`` for
    dense/projection workloads, ``"psram-stream"`` for sparse); ``config``
    the array config (default: paper §V-A, validated at backend
    construction). Returns a dict: backend, cycles (CycleCounts), time_s,
    utilization (SustainedBreakdown from counted cycles), energy
    (EnergyBreakdown) — plus projection_rel_err for ArchConfig workloads,
    model/imbalance for sparse ones. Only the fidelity probe touches
    ``device``; the prices are counted on the host.
    """
    from repro_torch.core.perf_model import MTTKRPWorkload, SparseMTTKRPWorkload
    from repro_torch.models.config import ArchConfig

    if isinstance(workload, ArchConfig):
        return _projection_report(workload, backend, config, batch, fidelity, device)
    if isinstance(workload, SparseMTTKRPWorkload):
        return _sparse_report(workload, backend, config, n_arrays, fabric)
    # duck-type fiber-length sequences: any 1-D array-like (numpy, tensor,
    # list, tuple) is a sparse distribution
    if not isinstance(workload, MTTKRPWorkload):
        try:
            fibers = np.asarray(workload)
        except (TypeError, ValueError):      # not an array-like (a card tensor too)
            fibers = None
        if fibers is not None and fibers.ndim == 1 and fibers.size \
                and np.issubdtype(fibers.dtype, np.number):
            return _sparse_report(
                SparseMTTKRPWorkload(fiber_lengths=fibers, rank=rank),
                backend, config, n_arrays, fabric)
    if isinstance(workload, MTTKRPWorkload):
        from repro_torch import api

        est = api.estimate(workload, backend=backend or "psram-scheduled",
                           config=config)
        return {
            "backend": est.backend,
            "cycles": est.counts,
            "time_s": est.time_s,
            "utilization": est.breakdown,
            "energy": est.energy,
        }
    raise TypeError(
        "offload_report takes an ArchConfig (decode-step projections), a "
        "SparseMTTKRPWorkload / fiber-length array, or a MTTKRPWorkload — "
        f"got {type(workload).__name__}"
    )


def _projection_report(cfg, backend, config, batch, fidelity, device):
    """Decode-step projections priced per unique shape through api.estimate.

    The fidelity probe draws ``x`` (m, k) and ``w`` (k, n) of the first
    shape from a generator seeded 0 on ``device`` (not the reference's JAX
    keys, so ``projection_rel_err`` agrees with the reference's within the
    spread over seeds, not to the bit) and holds the backend's ``x @ w``
    against the exact f32 product (TF32 off)."""
    from repro_torch import api, backends
    from repro_torch.core.perf_model import breakdown_from_counts

    be = backends.get(backend or "psram-scheduled", config)
    arr = be.config
    shapes = _decode_projection_shapes(cfg, batch)
    # layers repeat the same few shapes — estimate each unique shape once,
    # with the IR's repeats field carrying the layer count
    ests = [
        api.estimate(backends.MatmulWorkload(m, k, n, repeats=times),
                     backend=be)
        for (m, k, n), times in Counter(shapes).items()
    ]
    counts = sum((e.counts for e in ests[1:]), ests[0].counts)
    energy = sum((e.energy for e in ests[1:]), ests[0].energy)
    rel_err = None
    if fidelity and be.capabilities().matmul:
        m, k, n = shapes[0]
        dev = as_device(device)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev)
        got = be.matmul(x, w)
        with ieee_f32():
            exact = x @ w
        rel_err = float(torch.linalg.norm(got - exact) / torch.linalg.norm(exact))
    return {
        "backend": be.name,
        "cycles": counts,
        "time_s": counts.duration_s(arr),
        "utilization": breakdown_from_counts(arr, counts),
        "energy": energy,
        "projection_rel_err": rel_err,
    }


def _sparse_report(workload, backend, config, n_arrays, fabric=None):
    """Streaming sparse MTTKRP priced per array partition, model-checked.

    Prices through the mesh makespan model
    (:func:`repro_torch.sparse.mesh.mesh_counted_price`): the
    makespan-planner split, per-array counted cycles, and the electrical
    fabric's all-reduce of the partial outputs serialized after the slowest
    array.
    """
    from repro_torch import api, backends
    from repro_torch.core.perf_model import MeshSparseMTTKRPWorkload, breakdown_from_counts
    from repro_torch.core.schedule import program_energy
    from repro_torch.sparse.mesh import mesh_counted_price

    be = backends.get(backend or "psram-stream", config)
    arr = be.config
    # the selected backend must actually be able to price this workload —
    # refuse execution-only or dense-only backends instead of mislabeling
    # the stream schedule's bill with their name
    if "sparse" not in be.capabilities().prices:
        raise backends.CapabilityError(
            f"backend {be.name!r} cannot price a sparse MTTKRP workload; "
            "use 'psram-stream' or 'analytical'"
        )
    out_rows = None
    if isinstance(workload, MeshSparseMTTKRPWorkload):
        # a mesh workload carries its own topology — its fields win
        n_arrays = workload.n_arrays
        fabric = workload.fabric if workload.fabric is not None else fabric
        out_rows = workload.out_rows
    price, ps = mesh_counted_price(
        workload.fiber_lengths, workload.rank, arr, n_arrays=n_arrays,
        fabric=fabric, out_rows=out_rows)
    counts = price.counts
    energy = sum((program_energy(p) for p in ps.programs[1:]),
                 program_energy(ps.programs[0]))
    return {
        "backend": be.name,
        "cycles": counts,
        "time_s": price.duration_s(arr),
        "utilization": breakdown_from_counts(arr, counts),
        "energy": energy,
        "model": api.estimate(workload, backend="analytical",
                              config=arr).breakdown,
        "imbalance": ps.imbalance,
        "makespan_cycles": price.makespan_cycles,
        "reduce_cycles": price.reduce_cycles,
        "n_arrays": price.n_arrays,
    }


# The reference package removed its pre-registry adapters; ask for them and
# get a pointed error instead of a bare AttributeError.
_REMOVED = {
    "photonic_offload_report":
        "was removed from the reference package; use "
        "serve.offload_report(arch_cfg, backend=...)",
    "sparse_offload_report":
        "was removed from the reference package; use "
        "serve.offload_report(fiber_lengths, backend=..., n_arrays=...)",
}


def __getattr__(name):
    if name in _REMOVED:
        raise AttributeError(f"repro_torch.serve.{name} {_REMOVED[name]}")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def make_serve_step(cfg, *, deltas: bool = False):
    """serve_step(params, cache, token, cache_pos) -> (logits, cache).

    ``cache_pos`` may be an int (whole batch at one position — the classic
    ``ServeEngine`` loop) or a ``(B,)`` tensor (continuous batching). With
    ``deltas=True`` the step returns ``(logits, deltas)`` and leaves the
    cache as it was.
    """
    mod = get_module(cfg)
    if deltas:
        if not hasattr(mod, "decode_step_deltas"):
            raise ValueError(
                f"family {cfg.family!r} has no delta-form decode step; the "
                "paged serve loop supports decoder-only families")

        def step(params, cache, token, cache_pos):
            return mod.decode_step_deltas(params, cache, token, cache_pos, cfg)

        return step

    def step(params, cache, token, cache_pos):
        return mod.decode_step(params, cache, token, cache_pos, cfg)

    return step


def make_prefill(cfg, cache_len: int | None = None, *, paged: bool = False):
    """Prefill builder: ``prefill(params, tokens)`` — for the
    encoder-decoder family ``prefill(params, frames, tokens)`` — returns
    (last-token logits, cache padded to ``cache_len``). ``paged=True``
    returns ``prefill(params, tokens, last)`` — logits at index ``last``
    (prompts are right-padded to a bucket) and UNPADDED caches for the serve
    loop to scatter into its page slab (``transformer.prefill_paged``)."""
    mod = get_module(cfg)
    if paged:
        if not hasattr(mod, "prefill_paged"):
            raise ValueError(
                f"family {cfg.family!r} has no paged prefill; the paged "
                "serve loop supports decoder-only families")

        def prefill(params, tokens, last):
            return mod.prefill_paged(params, tokens, cfg, last)

        return prefill
    if cache_len is None:
        raise ValueError("cache_len is required for the dense prefill")

    if cfg.family == "encdec":
        def prefill(params, frames, tokens):
            return mod.prefill(params, frames, tokens, cfg, cache_len=cache_len)
    else:
        def prefill(params, tokens):
            return mod.prefill(params, tokens, cfg, cache_len=cache_len)
    return prefill


class ServeEngine:
    def __init__(self, cfg, params, max_len: int = 256, mesh=None, sharding_rules=None,
                 device=None):
        """``device``: where the engine runs — the mesh's one device when a
        ``mesh`` is given (which ``device`` may name again), else the card
        unless the caller asks for the CPU."""
        self.cfg = cfg
        self.max_len = max_len
        self.device = mesh_device(mesh, device, "ServeEngine")
        self.mod = get_module(cfg)
        self.placed = mesh is not None and mesh.placed
        if self.placed:
            from repro_torch.dist.placement import distribute_tree
            params = distribute_tree(params, self.mod.param_specs(cfg), mesh,
                                     rules=sharding_rules)
        self.params = params
        # mesh: prefill and decode run under use_sharding so the models'
        # dist.sharding hints compute their specs; None = hints are no-ops
        self.mesh = mesh
        self.sharding_rules = sharding_rules
        self.prefill_fn = make_prefill(cfg, max_len)
        self.step_fn = make_serve_step(cfg)

    def _sharding_ctx(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_sharding(self.mesh, rules=self.sharding_rules)

    @torch.inference_mode()
    def generate(
        self,
        prompts: torch.Tensor,         # (B, P) int, right-padded with 0
        prompt_len: int,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        generator: torch.Generator | None = None,
        frames: torch.Tensor | None = None,  # (B, S_enc, d_model), encoder-decoder only
    ) -> torch.Tensor:
        """``(B, max_new_tokens)`` int32 tokens. Greedy (``argmax``) unless
        ``temperature > 0`` and a ``generator`` is given. The encoder-decoder
        family needs ``frames``, the encoder's input."""
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} "
                f"exceeds the cache length {self.max_len}")
        prompts = prompts.to(self.device)
        if self.cfg.family == "encdec" and frames is None:
            raise ValueError("the encoder-decoder family needs frames= (B, S, d_model), "
                             "the encoder's input")
        with self._sharding_ctx():
            if self.placed:
                prompts = self._place(prompts, ("batch", "seq"))
                if frames is not None:
                    frames = self._place(frames.to(self.device), ("batch", "seq", None))
            if self.cfg.family == "encdec":
                logits, cache = self.prefill_fn(self.params, frames.to(self.device), prompts)
            else:
                logits, cache = self.prefill_fn(self.params, prompts)
            if self.placed and hasattr(self.mod, "cache_specs"):
                from repro_torch.dist.placement import distribute_tree
                cache = distribute_tree(cache, self.mod.cache_specs(
                    self.cfg, prompts.shape[0], self.max_len), self.mesh,
                    rules=self.sharding_rules)
            out = []
            tok = self._sample(logits, temperature, generator)
            pos = prompt_len
            for _ in range(max_new_tokens):
                out.append(tok)
                if self.placed:
                    tok = self._place(tok, ("batch",))
                logits, cache = self.step_fn(self.params, cache, tok, pos)
                tok = self._sample(logits, temperature, generator)
                pos += 1
        return torch.stack(out, dim=1)

    def _place(self, t, axes):
        """``t`` (the same on every rank) placed by its logical axes."""
        from repro_torch.dist.placement import distribute
        from repro_torch.dist.sharding import logical_to_spec
        return distribute(t, self.mesh, logical_to_spec(axes, t.shape, self.mesh,
                                                        rules=self.sharding_rules))

    def offload_report(self, backend=None, config=None, batch: int | None = None,
                       fidelity: bool = True):
        """What offloading this engine's decode projections would cost on the
        pSRAM array — see module-level :func:`offload_report` (its fidelity
        probe on the engine's device)."""
        return offload_report(
            self.cfg, backend=backend, config=config,
            batch=1 if batch is None else batch, fidelity=fidelity,
            device=self.device,
        )

    @staticmethod
    def _sample(logits, temperature, generator):
        """Greedy ``argmax``; with a temperature and a generator, a draw from
        ``softmax(logits / temperature)`` (not JAX's bits: a torch generator
        is not a JAX key). Placed logits are gathered first: every rank
        draws the same tokens."""
        from repro_torch.dist.placement import full
        logits = full(logits)
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
