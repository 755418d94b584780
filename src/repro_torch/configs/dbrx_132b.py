"""dbrx-132b [moe] — 40L d=6144 48H GQA kv=8 ff(expert)=10752 vocab=100352,
16 experts top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    act="swiglu",
    rope="full",
    num_experts=16,
    top_k=4,
    d_ff_expert=10752,
)
