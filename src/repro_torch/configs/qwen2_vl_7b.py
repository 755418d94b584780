"""qwen2-vl-7b [vlm] — 28L d=3584 28H GQA kv=4 ff=18944 vocab=152064.

M-RoPE over (t, h, w) position streams; dynamic-resolution vision frontend is
a STUB (precomputed patch embeddings / position ids). [arXiv:2409.12191; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    act="swiglu",
    rope="mrope",
    mrope_sections=(16, 24, 24),
)
