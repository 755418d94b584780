"""mamba2-370m [ssm] — 48L d=1024, attention-free, SSD state=128,
vocab=50280. [arXiv:2405.21060; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    rope="none",
    d_inner=2048,
    ssm_state=128,
    ssm_headdim=64,
    tie_embeddings=True,
)
