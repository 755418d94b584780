"""The optimizer: AdamW with bf16 params and f32 master and moment states,
and the logical-axis specs of its state (:mod:`~repro_torch.optim.adamw`)."""
from .adamw import (AdamWConfig, apply_updates, clip_by_global_norm, init_state,
                    schedule, state_spec_tree, state_specs, state_structs)

__all__ = ["AdamWConfig", "apply_updates", "clip_by_global_norm", "init_state",
           "schedule", "state_spec_tree", "state_specs", "state_structs"]
