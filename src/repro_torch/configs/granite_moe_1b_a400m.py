"""granite-moe-1b-a400m [moe] — 24L d=1024 16H GQA kv=8 ff(expert)=512
vocab=49155, 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    act="swiglu",
    rope="full",
    num_experts=32,
    top_k=8,
    d_ff_expert=512,
)
