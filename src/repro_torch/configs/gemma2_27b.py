"""gemma2-27b [dense] — 46L d=4608 32H GQA kv=16 ff=36864 vocab=256000.

Alternating local(4096)/global attention, attn-logit softcap 50, final
softcap 30, GeGLU, sandwich norms, scaled embeddings, query scale from
d_model/n_heads. [arXiv:2408.00118; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    act="geglu",
    rope="full",
    sliding_window=4096,
    alt_local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    post_block_norms=True,
    scale_embeddings=True,
    tie_embeddings=True,
)
