"""The optimizer: AdamW with bf16 params and f32 master and moment states
(:mod:`~repro_torch.optim.adamw`). The reference's ``state_specs`` and
``state_spec_tree`` come with ``dist.sharding`` (ROADMAP Queue A item 9b)."""
from .adamw import (AdamWConfig, apply_updates, clip_by_global_norm, init_state,
                    schedule, state_structs)

__all__ = ["AdamWConfig", "apply_updates", "clip_by_global_norm", "init_state",
           "schedule", "state_structs"]
