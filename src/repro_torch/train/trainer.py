"""Fault-tolerant training loop.

Responsibilities beyond calling the step:
  * checkpoint/restart — periodic async saves, resume from ``latest``,
    restart-exact data (a batch is a pure function of the step);
  * straggler/hang watchdog — per-step wall time is tracked; steps slower
    than ``straggler_factor`` x the trailing median are logged as
    stragglers (on a fleet this feeds the health controller that triggers
    hot spares; here it is surfaced in ``stragglers`` and the heartbeat
    file);
  * heartbeat — a small json blob per step for external supervisors.

A step is timed by ``obs.stopwatch("train/step")``, which waits for the
card's queued work at both edges, so its ``duration_s`` holds the step's
device work (the reference's ``block_until_ready``) and a ``train/step``
span lands in the trace whenever tracing is on.

``mesh=`` (a ``launch.mesh.ModelMesh``) and ``sharding_rules=`` run every
step under ``dist.sharding.use_sharding``, so the models' hints compute
their specs. On a mesh of one device without a process group the state
lives on that device. On a mesh under a process group the params are
drawn shard-invariantly onto it (``dist.placement.init_placed``: the
one-card draw), FSDP where ``estimate_fsdp`` says so (or ``fsdp=``), the
optimizer state placed as its params, and each step's batch sharded over
the data axes; the checkpoint gathers each leaf and restores onto the
mesh. Port of the reference module whole.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import time

import torch

from repro_torch import obs
from repro_torch._tree import tree_map
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.dist.sharding import estimate_fsdp, logical_to_spec, mesh_device, use_sharding
from repro_torch.optim import AdamWConfig

from .step import init_train_state, make_train_step


class Trainer:
    def __init__(
        self,
        cfg,
        data_cfg: DataConfig,
        opt_cfg: AdamWConfig | None = None,
        ckpt_dir: str | None = None,
        ckpt_every: int = 50,
        microbatches: int = 1,
        compress_grads: bool = False,
        error_feedback: bool = False,
        mesh=None,
        sharding_rules=None,
        straggler_factor: float = 2.0,
        seed: int = 0,
        device=None,
        fsdp: bool | None = None,
    ):
        self.device = mesh_device(mesh, device, "Trainer")
        # mesh: every step runs under use_sharding, so the models' hints
        # compute their specs; None keeps single-process behavior
        self.mesh = mesh
        self.sharding_rules = sharding_rules
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.error_feedback = bool(error_feedback)  # implies compression
        self.step_fn = make_train_step(cfg, self.opt_cfg, microbatches,
                                       compress_grads or error_feedback,
                                       error_feedback=self.error_feedback)
        # the state is built without opt_cfg, as the reference's Trainer
        # builds it: f32 m and unfactored v (apply_updates casts m to
        # opt_cfg.m_dtype from the first step on)
        self.placed = mesh is not None and mesh.placed
        if self.placed:
            from repro_torch.dist.placement import init_placed
            from repro_torch.optim import init_state
            n_params = cfg.param_count()
            # FSDP: the params, and with them the optimizer state, shard over
            # the data axes too where estimate_fsdp says so (or as asked)
            self.fsdp = estimate_fsdp(n_params, mesh, training=True) if fsdp is None else fsdp
            self.params = init_placed(cfg, seed, mesh, fsdp=self.fsdp, rules=sharding_rules)
            self.opt_state = init_state(self.params)
        else:
            self.fsdp = False
            self.params, self.opt_state = init_train_state(seed, cfg, device=self.device)
        self.residual = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                  self.params)
                         if self.error_feedback else None)
        self.start_step = 0
        if self.ckpt is not None:
            try:
                state, step = self.ckpt.restore(self._ckpt_tree())
                self.params, self.opt_state = state["params"], state["opt"]
                self.residual = state.get("residual", self.residual)
                self.start_step = step
            except FileNotFoundError:
                pass

    def _ckpt_tree(self):
        """Checkpointed state; the EF residual rides along so restarts stay
        exact (dropping it would silently zero the compression carry)."""
        tree = {"params": self.params, "opt": self.opt_state}
        if self.error_feedback:
            tree["residual"] = self.residual
        return tree

    def _heartbeat(self, step, loss, dt):
        if self.ckpt is None:
            return
        hb = {
            "step": int(step),
            "loss": loss,
            "step_time_s": dt,
            "stragglers": self.stragglers[-5:],
            "time": time.time(),
        }
        with open(os.path.join(self.ckpt.dir, "heartbeat.json"), "w") as f:
            json.dump(hb, f)

    def run(self, num_steps: int, log_every: int = 10, log_fn=print) -> list[float]:
        """Train ``num_steps`` steps from ``start_step``; returns the losses."""
        ctx = (use_sharding(self.mesh, rules=self.sharding_rules)
               if self.mesh is not None else contextlib.nullcontext())
        with ctx:
            return self._run(num_steps, log_every, log_fn)

    def _run(self, num_steps, log_every, log_fn):
        history = []
        for step in range(self.start_step, self.start_step + num_steps):
            tokens, labels = batch_at_step(self.data_cfg, step, device=self.device)
            batch = {"tokens": tokens, "labels": labels}
            if self.placed:
                from repro_torch.dist.placement import distribute
                batch = {k: distribute(v, self.mesh, logical_to_spec(
                    ("batch", "seq"), v.shape, self.mesh, rules=self.sharding_rules))
                    for k, v in batch.items()}
            # the obs stopwatch owns the step measurement: it always times
            # (the watchdog and heartbeat need dt regardless) and records a
            # "train/step" span whenever tracing is on
            with obs.stopwatch("train/step", step=step) as sw:
                if self.error_feedback:
                    self.params, self.opt_state, metrics, self.residual = self.step_fn(
                        self.params, self.opt_state, batch, self.residual)
                else:
                    self.params, self.opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, batch)
            dt = sw.duration_s
            # straggler watchdog
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-20:])
                if dt > self.straggler_factor * med:
                    self.stragglers.append(step)
            self.step_times.append(dt)
            loss = float(metrics["loss"])
            history.append(loss)
            self._heartbeat(step, loss, dt)
            if step % log_every == 0:
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f} ms")
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self._ckpt_tree())
        if self.ckpt is not None:
            self.ckpt.save(self.start_step + num_steps, self._ckpt_tree(), blocking=True)
        return history
