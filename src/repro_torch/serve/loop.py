"""Live serving loop: admission, continuous batching, paged KV, offload.

An actual request loop instead of the fixed-batch ``ServeEngine.generate``.
Requests arrive on a (synthetic, seeded) timeline
(`repro_torch.serve.traffic`), wait in a FIFO admission queue gated by
``PagedKVManager.can_admit``, and decode under *continuous batching*: rows
join and leave the batch between steps, every row at its own sequence
length. A port of ``repro.serve.loop`` with the same schedule: given the
same stream (and, at ``speedup`` high enough that every request is queued
before the first admission, the same timing), it admits, preempts and
steps exactly as the reference does, and samples on the host from the same
numpy generator.

How the pieces fit:

* **physical KV = one slab.** Every attention layer's ``k`` and ``v`` live
  in one tensor ``(L_attn, 2, num_slots + 1, Hkv, hd)`` on the loop's
  device, in the model's dtype, with ``num_slots = num_pages * page_size``
  token slots addressed by the page tables of
  :class:`~repro_torch.serve.kv_cache.PagedKVManager` (the reference keeps
  one slab ``(num_slots + 1, G, Hkv, hd)`` a cache leaf; the values at a
  slot are the same). Slot ``num_slots`` is sacrificial: padding rows
  gather from and scatter to it, so ragged batches need no masking on the
  memory side. Every pad position scatters to it, and which of several
  writes to one slot wins is undefined on the card; it is only ever read
  under the mask.
* **decode = gather / step / scatter.** Each step gathers every row's slots
  into a dense view ``(L_attn, 2, max_batch, S_v, Hkv, hd)`` with ONE
  ``index_select`` (:func:`~repro_torch.serve.kv_cache.gather_cache`, along
  the slot axis, so each layer's ``(B, S_v, Hkv, hd)`` k and v are
  contiguous views of it), runs the model's delta-form step
  (``make_serve_step(cfg, deltas=True)``, per-row ``(B,)`` ``cache_pos``)
  and scatters the one-token deltas into each row's newest slot with ONE
  ``index_copy_`` after one ``torch.stack`` of the deltas: three launches
  a step for the whole KV, where a slab a layer and leaf would take
  ``2 L_attn`` gathers and as many scatters (144 on granite-8b). Stale slots
  beyond a row's length are masked *inside* the attention
  (``k_pos < cache_pos``), which is what makes extend-before-step safe.
  The view lives until the step ends: on granite-8b (36 layers, Hkv 8, hd
  128, bf16) a token slot is 147,456 B, so 8 rows at ``S_v = 2048`` gather
  2.42 GB a step.
* **host traffic.** A step's ``token``, ``cache_pos``, ``new_slots`` and
  ``gather_idx`` are built in numpy, as the reference builds them, and go
  to the device in one copy; the logits come back in one copy for the host
  sampler. A prefill's padded tokens and slots go in one copy too.
* **bounded shapes.** Prompts right-pad and the gather view rounds up to
  power-of-two buckets from ``min_bucket``, so a stream meets O(log
  capacity) distinct shapes (the reference compiles once a bucket; eager
  PyTorch has nothing to compile, but cuBLAS picks its kernels and the
  hand-written kernels build at a shape's first call). Prefill takes its
  logits at index ``prompt_len - 1``.
* **admission / preemption.** Admission is FIFO with head-of-line
  blocking; a request whose prompt (or prompt + decode budget) can never
  fit is rejected up front. When a mid-decode page allocation fails, the
  *youngest* live row is preempted (pages freed, its request requeued at
  the queue front, generated tokens discarded — recompute-style), which
  guarantees forward progress for the oldest row; past ``max_preemptions``
  the request fails (``"preempt-limit"``), and past ``deadline_s`` since
  its arrival it fails too (``"deadline"``).
* **offload.** Before each decode step the
  :class:`~repro_torch.serve.scheduler.OffloadScheduler` prices the batch's
  projection matmuls on the pSRAM mesh (counted cycles, LPT makespan over
  ``n_arrays``) and decides pSRAM-vs-host against the measured host EMA.
  Execution stays on the loop's device (there is no photonic silicon); the
  decision trail — the modeled makespan next to the measured step wall
  time, per batch — is ``ServeReport.offload``.

Every phase is observable (`repro_torch.obs`): spans ``serve/admit``,
``serve/offload``, ``serve/evict``, ``serve/fail``; stopwatches
``serve/prefill`` and ``serve/decode`` (they wait for the card at both
edges; the decode's measured seconds feed the scheduler's host EMA);
counters ``serve/admitted``, ``serve/rejected``, ``serve/preempted``,
``serve/prefills``, ``serve/decode_steps``, ``serve/tokens``,
``serve/failed``.

The loop is a single-consumer ``asyncio`` engine: a producer task releases
requests at their (speedup-scaled) arrival times while the engine task
alternates admit/step, yielding between steps. ``run_sync`` wraps it for
scripts and tests.
"""
from __future__ import annotations

import asyncio
import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import as_device
from repro_torch.models.registry import get_module
from repro_torch.serve import traffic as traffic_mod
from repro_torch.serve.engine import make_prefill, make_serve_step
from repro_torch.serve.kv_cache import PagedCacheConfig, PagedKVManager, gather_cache
from repro_torch.serve.scheduler import OffloadScheduler

_KV = ("k", "v")


@dataclasses.dataclass(frozen=True)
class ServeLoopConfig:
    """Engine knobs (model-independent; the model comes from ArchConfig)."""

    max_batch: int = 8            # decode rows (the step's batch dimension)
    num_pages: int = 64
    page_size: int = 16
    temperature: float = 0.0      # 0 = greedy; >0 = seeded gumbel sampling
    sample_seed: int = 0
    speedup: float = 1.0          # arrival-time compression: wall = sim/speedup
    min_bucket: int = 8           # smallest pad/view bucket (powers of two up)
    idle_poll_s: float = 0.0005   # engine sleep when nothing is runnable
    max_preemptions: int = 8      # evictions per request before it fails
                                  # cleanly ("preempt-limit") — page pressure
                                  # can delay a request but never livelock it
    deadline_s: float | None = None  # per-request wall deadline since arrival
                                     # (post-speedup); None = no timeouts.
                                     # Overdue queued requests are shed at
                                     # admission, overdue active rows fail
                                     # and free their pages ("deadline")


@dataclasses.dataclass
class RequestRecord:
    """Per-request lifecycle timestamps (seconds since run start, wall)."""

    rid: int
    prompt_len: int
    decode_len: int
    arrival_s: float | None = None
    admitted_s: float | None = None
    first_token_s: float | None = None
    finished_s: float | None = None
    n_generated: int = 0
    preemptions: int = 0
    rejected: bool = False
    failed: bool = False
    failure: str | None = None    # "preempt-limit" | "deadline" when failed
    tokens: list[int] = dataclasses.field(default_factory=list)

    @property
    def finished(self) -> bool:
        return self.finished_s is not None

    @property
    def latency_s(self) -> float | None:
        if self.finished_s is None or self.arrival_s is None:
            return None
        return self.finished_s - self.arrival_s

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_s is None or self.arrival_s is None:
            return None
        return self.first_token_s - self.arrival_s


@dataclasses.dataclass
class ServeReport:
    """What one run did: per-request records + engine-level aggregates."""

    records: list[RequestRecord]
    duration_s: float
    n_prefills: int
    n_steps: int
    preemptions: int
    leaked_pages: int             # pages still allocated after drain: must be 0
    peak_utilization: float
    mean_fragmentation: float
    offload: list[dict]           # per-step: target, modeled_s, measured_s, ...
    speedup: float

    @property
    def completed(self) -> list[RequestRecord]:
        return [r for r in self.records if r.finished]

    @property
    def rejected(self) -> list[RequestRecord]:
        return [r for r in self.records if r.rejected]

    @property
    def failed(self) -> list[RequestRecord]:
        return [r for r in self.records if r.failed]

    def _pct(self, values, q) -> float:
        return float(np.percentile(np.asarray(values), q)) if values else 0.0

    @property
    def p50_latency_s(self) -> float:
        return self._pct([r.latency_s for r in self.completed], 50)

    @property
    def p99_latency_s(self) -> float:
        return self._pct([r.latency_s for r in self.completed], 99)

    @property
    def p50_ttft_s(self) -> float:
        return self._pct([r.ttft_s for r in self.completed], 50)

    @property
    def p99_ttft_s(self) -> float:
        return self._pct([r.ttft_s for r in self.completed], 99)

    @property
    def throughput_rps(self) -> float:
        return len(self.completed) / max(self.duration_s, 1e-9)

    @property
    def throughput_tok_s(self) -> float:
        toks = sum(r.n_generated for r in self.completed)
        return toks / max(self.duration_s, 1e-9)

    @property
    def offload_fraction(self) -> float:
        if not self.offload:
            return 0.0
        hits = sum(1 for o in self.offload if o["target"] == "psram")
        return hits / len(self.offload)

    def summary(self) -> dict:
        """JSON-ready aggregate view of the run."""
        modeled = [o["modeled_s"] for o in self.offload]
        measured = [o["measured_s"] for o in self.offload]
        failures: dict[str, int] = {}
        for r in self.failed:
            failures[r.failure or "?"] = failures.get(r.failure or "?", 0) + 1
        return {
            "completed": len(self.completed),
            "rejected": len(self.rejected),
            "failed": len(self.failed),
            "failure_reasons": failures,
            "preemptions": self.preemptions,
            "leaked_pages": self.leaked_pages,
            "duration_s": self.duration_s,
            "p50_latency_s": self.p50_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "p50_ttft_s": self.p50_ttft_s,
            "p99_ttft_s": self.p99_ttft_s,
            "throughput_rps": self.throughput_rps,
            "throughput_tok_s": self.throughput_tok_s,
            "offload_fraction": self.offload_fraction,
            "mean_modeled_step_s": float(np.mean(modeled)) if modeled else 0.0,
            "mean_measured_step_s": (float(np.mean(measured))
                                     if measured else 0.0),
            "peak_utilization": self.peak_utilization,
            "mean_fragmentation": self.mean_fragmentation,
        }


@dataclasses.dataclass
class _Active:
    """One live decode row."""

    req: traffic_mod.Request
    row: int
    admit_seq: int                # monotonically increasing admission order
    next_token: int               # the token the next step feeds
    pos: int                      # tokens written to the KV (cache_pos)
    generated: list[int]


class ServeLoop:
    """The live engine. One instance owns one page slab + one KV manager on
    ``device`` (the card unless the caller asks for the CPU); ``run`` /
    ``run_sync`` drive a request list (or a TrafficConfig) through it and
    return a :class:`ServeReport`. ``params`` default to the model's
    ``init`` from seed 0 on ``device``."""

    def __init__(self, cfg, params=None, loop_cfg: ServeLoopConfig | None = None,
                 scheduler: OffloadScheduler | None = None, device="cuda"):
        self.cfg = cfg
        self.loop_cfg = loop_cfg or ServeLoopConfig()
        self.device = as_device(device)
        self.mod = get_module(cfg)
        self._prefill_fn = make_prefill(cfg, paged=True)
        self._step_fn = make_serve_step(cfg, deltas=True)
        template = self.mod.init_cache(cfg, 1, 1, device="cpu")
        if any(set(layer) != set(_KV) for group in template for layer in group.values()):
            raise ValueError(
                f"family {cfg.family!r} carries non-KV cache state (conv/ssm "
                "recurrences); the paged serve loop supports all-attention "
                "layouts")
        self.params = params if params is not None else \
            self.mod.init(0, cfg, device=self.device)
        self.scheduler = scheduler or OffloadScheduler()
        self.kv = PagedKVManager(PagedCacheConfig(
            num_pages=self.loop_cfg.num_pages,
            page_size=self.loop_cfg.page_size))
        self._rng = np.random.default_rng(self.loop_cfg.sample_seed)
        self._pad_slot = self.kv.cfg.capacity_tokens
        n_slots = self._pad_slot + 1  # +1 sacrificial slot for padding rows
        # the slab's layer axis, in the model's order: (group, "layer<i>")
        self._layers = [(g, key) for g, group in enumerate(template) for key in group]
        leaf = template[0][self._layers[0][1]]["k"]
        with torch.inference_mode():
            self.slab = torch.zeros((len(self._layers), 2, n_slots, *leaf.shape[2:]),
                                    dtype=leaf.dtype, device=self.device)

    # ---------------------------------------------------------------- helpers
    def _bucket(self, n: int) -> int:
        b = self.loop_cfg.min_bucket
        while b < n:
            b *= 2
        return b

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.loop_cfg.temperature <= 0.0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        g = self._rng.gumbel(size=logits.shape)
        return np.argmax(
            logits / self.loop_cfg.temperature + g, axis=-1).astype(np.int32)

    def _never_fits(self, req) -> bool:
        """True when no amount of waiting could admit + finish this request."""
        kv = self.kv
        return (kv.pages_needed(req.prompt_len) + 1 > kv.cfg.num_pages
                or kv.pages_needed(req.prompt_len + req.decode_len)
                > kv.cfg.num_pages)

    def _to_device(self, *arrays) -> list[torch.Tensor]:
        """The host arrays as int64 tensors on the device, in ONE copy."""
        flat = np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        out, at = [], 0
        for a in arrays:
            n = int(np.size(a))
            out.append(dev[at:at + n].view(np.shape(a)))
            at += n
        return out

    def _view(self, gather_idx: torch.Tensor) -> list[dict]:
        """The model's cache (a list over groups of ``{"layer<i>": {"k",
        "v"}}``, each ``(B, S_v, Hkv, hd)``) gathered from the slab at the
        ``(B, S_v)`` slots ``gather_idx``: one ``index_select``."""
        view = gather_cache(self.slab, gather_idx, dim=2)
        cache = [{} for _ in range(self.cfg.num_groups)]
        for i, (g, key) in enumerate(self._layers):
            cache[g][key] = {"k": view[i, 0], "v": view[i, 1]}
        return cache

    def _scatter(self, tree: list[dict], slots: torch.Tensor) -> None:
        """Write a model cache tree's token rows into the slab at ``slots``:
        a prefill's ``(1, S_pad, Hkv, hd)`` leaves (slots ``(S_pad,)``) or a
        step's ``(B, 1, Hkv, hd)`` deltas (slots ``(B,)``). One stack of the
        leaves, one ``index_copy_``."""
        upd = torch.stack([tree[g][key][name].flatten(0, 1)
                           for g, key in self._layers for name in _KV])
        self.slab.index_copy_(2, slots, upd.unflatten(0, (len(self._layers), 2))
                              .to(self.slab.dtype))

    @torch.inference_mode()
    def _prefill_one(self, req) -> int:
        """Prefill one admitted request into its pages; returns its first
        generated token."""
        s_pad = self._bucket(req.prompt_len)
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :req.prompt_len] = req.prompt
        slots = np.full(s_pad, self._pad_slot, np.int64)
        slots[:req.prompt_len] = self.kv.physical_slots(req.rid)
        toks_d, slots_d = self._to_device(toks, slots)
        logits, caches = self._prefill_fn(self.params, toks_d, req.prompt_len - 1)
        self._scatter(caches, slots_d)
        return int(self._sample(logits.cpu().numpy())[0])

    def _step_inputs(self, step_rows: list[_Active]) -> tuple:
        """The host arrays of one decode step over ``step_rows``: (token,
        cache_pos, gather_idx (max_batch, S_v), new_slots); free rows feed
        token 0 at position 0 and point every slot at the sacrificial one."""
        lc = self.loop_cfg
        s_v = self._bucket(max(a.pos for a in step_rows))
        token = np.zeros(lc.max_batch, np.int32)
        cache_pos = np.zeros(lc.max_batch, np.int32)
        gather_idx = np.full((lc.max_batch, s_v), self._pad_slot, np.int32)
        new_slots = np.full(lc.max_batch, self._pad_slot, np.int32)
        for a in step_rows:
            slots = self.kv.physical_slots(a.req.rid)
            gather_idx[a.row, :a.pos] = slots[:a.pos]
            new_slots[a.row] = slots[a.pos]
            token[a.row] = a.next_token
            cache_pos[a.row] = a.pos
        return token, cache_pos, gather_idx, new_slots

    @torch.inference_mode()
    def _decode(self, token, cache_pos, gather_idx, new_slots) -> np.ndarray:
        """One gather / step / scatter on the device from the step's host
        arrays; returns the (max_batch, V) f32 logits on the host."""
        token, cache_pos, gather_idx, new_slots = self._to_device(
            token, cache_pos, gather_idx, new_slots)
        logits, deltas = self._step_fn(self.params, self._view(gather_idx), token, cache_pos)
        self._scatter(deltas, new_slots)
        return logits.cpu().numpy()

    @torch.inference_mode()
    def warmup(self, max_prompt: int, max_decode: int) -> int:
        """Run every shape bucket a stream with prompts up to ``max_prompt``
        and decodes up to ``max_decode`` can hit once, so the first measured
        requests don't pay for the library's kernel choices and the
        hand-written kernels' builds (eager PyTorch compiles nothing itself).

        Runs each prefill pad bucket and each decode view bucket once with
        dummy inputs routed entirely at the sacrificial pad slot (whose
        contents are never read unmasked), so the KV pool and the slab's
        live slots are untouched. Returns the number of calls."""
        lc = self.loop_cfg
        n = 0
        b = lc.min_bucket
        while True:
            toks, slots = self._to_device(np.zeros((1, b), np.int32),
                                          np.full(b, self._pad_slot, np.int64))
            _, caches = self._prefill_fn(self.params, toks, 0)
            self._scatter(caches, slots)
            n += 1
            if b >= max_prompt:
                break
            b *= 2
        s_v = lc.min_bucket
        while True:
            self._decode(np.zeros(lc.max_batch, np.int32), np.zeros(lc.max_batch, np.int32),
                         np.full((lc.max_batch, s_v), self._pad_slot, np.int32),
                         np.full(lc.max_batch, self._pad_slot, np.int32))
            n += 1
            if s_v >= max_prompt + max_decode:
                break
            s_v *= 2
        return n

    # ------------------------------------------------------------------- run
    async def run(self, requests) -> ServeReport:
        if isinstance(requests, traffic_mod.TrafficConfig):
            requests = traffic_mod.generate(requests)
        lc = self.loop_cfg
        aloop = asyncio.get_running_loop()
        t0 = aloop.time()

        def now() -> float:
            return aloop.time() - t0

        queue: deque = deque()
        records = {
            r.rid: RequestRecord(rid=r.rid, prompt_len=r.prompt_len,
                                 decode_len=r.decode_len)
            for r in requests
        }
        done_producing = asyncio.Event()

        async def producer():
            for r in sorted(requests, key=lambda q: q.arrival_s):
                delay = r.arrival_s / lc.speedup - now()
                if delay > 0:
                    await asyncio.sleep(delay)
                records[r.rid].arrival_s = now()
                queue.append(r)
            done_producing.set()

        prod = asyncio.ensure_future(producer())

        active: list[_Active | None] = [None] * lc.max_batch
        free_rows = list(reversed(range(lc.max_batch)))
        offload_log: list[dict] = []
        n_prefills = n_steps = preemptions = admit_seq = 0
        peak_util = frag_sum = 0.0
        frag_n = 0

        def finish(a: _Active):
            rec = records[a.req.rid]
            rec.finished_s = now()
            rec.n_generated = len(a.generated)
            rec.tokens = list(a.generated)
            self.kv.free_request(a.req.rid)
            active[a.row] = None
            free_rows.append(a.row)

        def fail(rid: int, reason: str):
            rec = records[rid]
            rec.failed = True
            rec.failure = reason
            obs.counter("serve/failed")
            with obs.span("serve/fail", rid=rid, reason=reason):
                pass

        def fail_active(a: _Active, reason: str):
            fail(a.req.rid, reason)
            records[a.req.rid].n_generated = len(a.generated)
            self.kv.free_request(a.req.rid)
            active[a.row] = None
            free_rows.append(a.row)

        def overdue(rid: int) -> bool:
            if lc.deadline_s is None:
                return False
            arr = records[rid].arrival_s
            return arr is not None and now() - arr > lc.deadline_s

        try:
            while not (done_producing.is_set() and not queue
                       and all(a is None for a in active)):
                progressed = False

                # -- deadlines: shed overdue queued work, time out live rows
                if lc.deadline_s is not None:
                    while queue and overdue(queue[0].rid):
                        fail(queue.popleft().rid, "deadline")
                        progressed = True
                    for a in list(active):
                        if a is not None and overdue(a.req.rid):
                            fail_active(a, "deadline")
                            progressed = True

                # -- admit: FIFO, head-of-line blocking ---------------------
                with obs.span("serve/admit", queued=len(queue)):
                    while queue and free_rows:
                        req = queue[0]
                        if self._never_fits(req):
                            queue.popleft()
                            records[req.rid].rejected = True
                            obs.counter("serve/rejected")
                            progressed = True
                            continue
                        if not self.kv.can_admit(req.prompt_len):
                            break
                        queue.popleft()
                        self.kv.admit(req.rid, req.prompt_len)
                        rec = records[req.rid]
                        rec.admitted_s = now()
                        obs.counter("serve/admitted")
                        with obs.stopwatch("serve/prefill", rid=req.rid,
                                           prompt=req.prompt_len):
                            tok = self._prefill_one(req)
                        if rec.first_token_s is None:
                            rec.first_token_s = now()
                        obs.counter("serve/prefills")
                        obs.counter("serve/tokens")
                        n_prefills += 1
                        a = _Active(req=req, row=free_rows.pop(),
                                    admit_seq=admit_seq, next_token=tok,
                                    pos=req.prompt_len, generated=[tok])
                        admit_seq += 1
                        active[a.row] = a
                        progressed = True
                        if len(a.generated) >= req.decode_len:
                            finish(a)

                # -- decode: extend (evicting under pressure), step ---------
                step_rows = sorted((a for a in active if a is not None),
                                   key=lambda a: a.admit_seq)
                if step_rows:
                    i = 0
                    while i < len(step_rows):
                        a = step_rows[i]
                        if self.kv.extend(a.req.rid, 1):
                            i += 1
                            continue
                        victim = step_rows[-1]  # youngest live row
                        with obs.span("serve/evict", rid=victim.req.rid):
                            self.kv.free_request(victim.req.rid)
                            active[victim.row] = None
                            free_rows.append(victim.row)
                            rec_v = records[victim.req.rid]
                            rec_v.preemptions += 1
                            preemptions += 1
                            obs.counter("serve/preempted")
                            if rec_v.preemptions > lc.max_preemptions:
                                # bounded retries exhausted: fail cleanly
                                # instead of requeueing — page pressure can
                                # never livelock the loop
                                fail(victim.req.rid, "preempt-limit")
                            else:
                                queue.appendleft(victim.req)
                        step_rows.pop()

                if step_rows:
                    b = len(step_rows)
                    with obs.span("serve/offload", batch=b):
                        decision = self.scheduler.decide_decode(self.cfg, b)

                    inputs = self._step_inputs(step_rows)
                    with obs.stopwatch("serve/decode", batch=b,
                                       view=int(inputs[2].shape[1])) as sw:
                        logits_np = self._decode(*inputs)
                    self.scheduler.observe_host(b, sw.duration_s)
                    offload_log.append({
                        "batch": b,
                        "target": decision.target,
                        "modeled_s": decision.modeled_s,
                        "host_ema_s": decision.host_s,
                        "measured_s": sw.duration_s,
                        "makespan_cycles": decision.price.makespan_cycles,
                        "n_arrays": decision.price.n_arrays,
                    })
                    n_steps += 1
                    obs.counter("serve/decode_steps")

                    next_tok = self._sample(logits_np)
                    for a in step_rows:
                        a.pos += 1
                        t = int(next_tok[a.row])
                        a.next_token = t
                        a.generated.append(t)
                        obs.counter("serve/tokens")
                        if len(a.generated) >= a.req.decode_len:
                            finish(a)
                    progressed = True

                util = self.kv.utilization()
                peak_util = max(peak_util, util)
                frag_sum += self.kv.fragmentation()
                frag_n += 1
                # yield so the producer can enqueue between steps
                await asyncio.sleep(0 if progressed else lc.idle_poll_s)
            await prod
        finally:
            if not prod.done():
                prod.cancel()

        return ServeReport(
            records=[records[r.rid] for r in requests],
            duration_s=now(),
            n_prefills=n_prefills,
            n_steps=n_steps,
            preemptions=preemptions,
            leaked_pages=self.kv.allocated_pages,
            peak_utilization=peak_util,
            mean_fragmentation=frag_sum / max(frag_n, 1),
            offload=offload_log,
            speedup=lc.speedup,
        )

    def run_sync(self, requests) -> ServeReport:
        return asyncio.run(self.run(requests))
