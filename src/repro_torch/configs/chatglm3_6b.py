"""chatglm3-6b [dense] — 28L d=4096 32H GQA kv=2 ff=13696 vocab=65024.

RoPE "2d" = partial rotary over half the head dim; SwiGLU. [arXiv:2406.12793; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    act="swiglu",
    rope="partial",
    rope_partial_frac=0.5,
)
