"""Serving engine: batched prefill + decode with a static KV cache.

`ServeEngine` handles a batch of requests end to end on the card (or the
CPU when asked): right-padded prompts (and, for the encoder-decoder family,
their frames), one prefill, then one decode step a token with greedy or
temperature sampling. `make_serve_step` builds the bare decode step (one
new token against a ``max_len`` cache); `make_prefill` the dense prefill.

PyTorch runs eagerly, so there is no compile step to wrap; the engine runs
under ``torch.inference_mode``. The KV cache is written in place.

Ported: ``make_serve_step`` (plain, and ``deltas=True`` for the decoder-only
families), ``make_prefill`` (the dense form; ``(params, frames, tokens)``
for the encoder-decoder family), ``ServeEngine`` (``generate`` with
``frames=``, ``_sample``). Still to come from the reference module:
``make_prefill(paged=True)`` (with the paged serve loop, ROADMAP Queue A
item 8), the ``mesh``/``sharding_rules`` arguments (item 8),
``offload_report`` and the engine's method of that name (item 8; they price
through ``api.estimate`` and, on a mesh, ``sparse.mesh``'s
``mesh_counted_price``, both ported).
"""
from __future__ import annotations

import torch

from repro_torch._device import as_device
from repro_torch.models.registry import get_module


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
    (last-token logits, cache padded to ``cache_len``)."""
    mod = get_module(cfg)
    if paged:
        raise NotImplementedError(
            "make_prefill(paged=True) waits for the paged serve loop "
            "(ROADMAP Queue A item 8)")
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
    def __init__(self, cfg, params, max_len: int = 256, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = as_device(device)
        self.mod = get_module(cfg)
        self.prefill_fn = make_prefill(cfg, max_len)
        self.step_fn = make_serve_step(cfg)

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
        if self.cfg.family == "encdec":
            if frames is None:
                raise ValueError("the encoder-decoder family needs frames= (B, S, d_model), "
                                 "the encoder's input")
            logits, cache = self.prefill_fn(self.params, frames.to(self.device), prompts)
        else:
            logits, cache = self.prefill_fn(self.params, prompts)
        out = []
        tok = self._sample(logits, temperature, generator)
        pos = prompt_len
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = self.step_fn(self.params, cache, tok, pos)
            tok = self._sample(logits, temperature, generator)
            pos += 1
        return torch.stack(out, dim=1)

    @staticmethod
    def _sample(logits, temperature, generator):
        """Greedy ``argmax``; with a temperature and a generator, a draw from
        ``softmax(logits / temperature)`` (not JAX's bits: a torch generator
        is not a JAX key)."""
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
