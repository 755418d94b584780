"""jamba-1.5-large (398B) [hybrid] — 72L d=8192 64H GQA kv=8 ff(expert)=24576
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave.

DESIGN.md records the Mamba-1 -> Mamba-2 SSD substitution for the SSM
layers. MoE on every other layer. [arXiv:2403.19887; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    act="swiglu",
    rope="none",       # jamba uses no positional encoding in attention layers
    num_experts=16,
    top_k=2,
    d_ff_expert=24576,
    moe_every=2,
    hybrid_attn_period=8,
    d_inner=16384,
    ssm_state=128,
    ssm_headdim=128,
)
