"""deepseek-7b [dense] — 30L d=4096 32H kv=32 (MHA) ff=11008 vocab=102400.

Llama-style. [arXiv:2401.02954; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    act="swiglu",
    rope="full",
)
